"""Where the device time of a 720p frame, or of a training step, goes, by
kernel.

    python -m realtime_stereo_matcher_tpu_torch.frame_profile [--model v1|v2|v3|v4|dispnetc] [--frames 8]
    python -m realtime_stereo_matcher_tpu_torch.frame_profile --train [--model v1|v2|v3|v4|dispnetc] [--frames 4]
    python -m realtime_stereo_matcher_tpu_torch.frame_profile --train --dp [--model v1|v2|v3] [--frames 4]

Builds the model (v1 by default, or v2 or v3) as ``bench.py`` does, runs
``--frames`` frames of the bf16 kernel path under ``torch.profiler`` after
two warm-up frames, and prints one JSON
line: per group of device kernels (each hand-written kernel by its template
shape, and the plain PyTorch ops by name) the device ms per frame and the
launches per frame, the port kernels of narrow channel pairs (any but
32 -> 32) summed by route (tensor cores, CUDA cores), plus the device busy
share over the profiled span
(kernel time / span from the first kernel's start to the last one's end).
Kernels of one stream do not overlap, so the sum is the busy time.

With ``--train`` the unit is one bf16 kernel-path training step of the
model's repo config and its train section (v1: batch 4, 480 x 640; v2 and
v3: batch 8, 240 x 320; seeded synthetic scenes, weights from the
train-start init), after two warm-up steps.

With ``--train --dp`` the step is the data-parallel one
(``make_fast_train_step(..., group=...)``) as the one rank of a NCCL group
in this process: the one-process step's work plus every collective of the
data-parallel step, trivial at one rank, so the difference from ``--train``
is the collectives' cost; ``collectives`` then gives their count and the
host ms of their ``c10d::`` ops per step.

MobileStereoNetV4 (``v4``) and MobileDispNetC (``dispnetc``) have no
kernel path: their frame is the plain forward and their step the plain
step (``train.trainer.make_train_step``), both under bf16 autocast, at
their repo configs (V4: batch 6, 240 x 320; DispNetC: batch 8, 256 x 320).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys

import torch

from realtime_stereo_matcher_tpu_torch import bench
from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.data.synthetic import SyntheticBatches
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.fast_infer import make_fast_forward
from realtime_stereo_matcher_tpu_torch.models.fast_train import (
    make_fast_train_step,
)
from realtime_stereo_matcher_tpu_torch.parallel.distributed import (
    default_group,
    free_port,
    init_group,
    shutdown,
)
from realtime_stereo_matcher_tpu_torch.train.trainer import (
    create_train_state,
    make_train_step,
)

# the models without a kernel path, by their repo configs
PLAIN_MODELS = {"v4": bench.CONFIGURE / "stereo_net_config_v4.json",
                "dispnetc": bench.CONFIGURE / "disp_net_c_config.json"}

# rsm::conv_kernel<T, CI, CO, S, KD, K>
_CONV = re.compile(r"conv_kernel<([^,]+),\s*(\d+),\s*(\d+),\s*(\d+),"
                   r"\s*(\d+)(?:,\s*(\d+))?>")
# rsm::tc::conv_tc_kernel<KD>: the bf16 32 -> 32 tensor-core convs (the
# profiler may print the argument as "1" or "(int)1")
_CONV_TC = re.compile(r"conv_tc_kernel<\s*(?:\(int\)\s*)?(\d+)")
# dw_partial_kernel<T, KD, CI, CO>
_DW = re.compile(r"dw_partial_kernel<([^,]+),\s*(\d+),\s*(\d+),\s*(\d+)>")
# rsm::tc::dw_tc_kernel<KD, CI, CO> (CI, CO 32, 32 where absent) and
# rsm::tc::conv_s2_tc_kernel<KT>: bf16 K4 (2D, 3D) and the bf16 32 -> 32
# stride-2 convs (KT = 3: K2, KT = 4: K2-4x4) on the tensor cores
_INT = r"\s*(?:\(int\)\s*)?(\d+)"
_DW_TC = re.compile(rf"dw_tc_kernel<{_INT}(?:,{_INT},{_INT})?")
_S2_TC = re.compile(rf"conv_s2_tc_kernel<{_INT}")
# rsm::tc::conv_nin_tc_kernel<CI> / conv_nout_tc_kernel<CO>: the bf16
# stride-1 narrow pairs of K1 (CI -> 32, 32 -> CO) on the tensor cores
_NIN_TC = re.compile(rf"conv_nin_tc_kernel<{_INT}")
_NOUT_TC = re.compile(rf"conv_nout_tc_kernel<{_INT}")
# rsm::tc::conv_s2_nin_tc_kernel<CI> (K2's CI -> 32 stem) and
# rsm::tc::conv3d_nout_tc_kernel / conv3d_nin_tc_kernel (K3's 32 -> 1 head
# and its 1 -> 32 dx): the bf16 narrow pairs of K2 and K3 on the tensor
# cores
_S2_NIN_TC = re.compile(rf"conv_s2_nin_tc_kernel<{_INT}")
_K3_NARROW_TC = re.compile(r"conv3d_n(in|out)_tc_kernel\b")


def kernel_group(name: str) -> str:
    """A device kernel's group: the port's kernels by (kernel, C_in, C_out),
    anything else by its name up to the template arguments."""
    m = _CONV_TC.search(name)
    if m:
        kernel = "fused_conv3d" if m.group(1) == "3" else "fused_conv3x3"
        return f"{kernel} 32->32"
    m = _S2_NIN_TC.search(name)
    if m:
        return f"fused_conv3x3_s2 {m.group(1)}->32"
    m = _K3_NARROW_TC.search(name)
    if m:
        return "fused_conv3d " + ("1->32" if m.group(1) == "in" else "32->1")
    m = _S2_TC.search(name)
    if m:
        kernel = "fused_conv4x4_s2" if m.group(1) == "4" else "fused_conv3x3_s2"
        return f"{kernel} 32->32"
    m = _DW_TC.search(name)
    if m:
        kd, ci, co = m.group(1), m.group(2) or "32", m.group(3) or "32"
        return f"dw_reduce{' 3D' if kd == '3' else ''} {ci}->{co}"
    m = _NIN_TC.search(name)
    if m:
        return f"fused_conv3x3 {m.group(1)}->32"
    m = _NOUT_TC.search(name)
    if m:
        return f"fused_conv3x3 32->{m.group(1)}"
    m = _CONV.search(name)
    if m:
        _, ci, co, s, kd, k = m.groups()
        kernel = ("fused_conv3d" if kd == "3" else
                  "fused_conv4x4_s2" if k == "4" else
                  "fused_conv3x3_s2" if s == "2" else "fused_conv3x3")
        return f"{kernel} {ci}->{co}"
    m = _DW.search(name)
    if m:
        _, kd, ci, co = m.groups()
        return f"dw_reduce{' 3D' if kd == '3' else ''} {ci}->{co}"
    if "dw_sum_kernel" in name:
        return "dw_reduce partial sums"
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return "plain: " + name.split("<")[0].split("(")[0][:80].strip()


def kernel_route(name: str) -> str | None:
    """Where a port kernel runs: "tensor cores" or "cuda cores"; None for
    anything else (plain PyTorch, the partial sums of K4)."""
    if any(r.search(name) for r in (_CONV_TC, _S2_TC, _DW_TC, _NIN_TC,
                                    _NOUT_TC, _S2_NIN_TC, _K3_NARROW_TC)):
        return "tensor cores"
    if _CONV.search(name) or _DW.search(name):
        return "cuda cores"
    return None


def frame_fn(dev, seed, model="v1"):
    """One bf16 720p frame of ``model``'s kernel path (the plain forward
    under autocast for V4 and DispNetC)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    left, right = (torch.rand((1, *bench.HW, 3), generator=gen, device=dev)
                   * 255 for _ in range(2))
    if model in PLAIN_MODELS:
        net = build_model(load_config(PLAIN_MODELS[model]).model.as_dict(),
                          device=dev,
                          generator=torch.Generator().manual_seed(seed))

        @torch.no_grad()
        def forward(left, right):
            with torch.autocast(dev.type, dtype=torch.bfloat16):
                return net(left, right)
    else:
        forward = make_fast_forward(build_model(
            bench.model_config(model), device=dev,
            generator=torch.Generator().manual_seed(seed)))
    return lambda: forward(left, right)


def train_step_fn(dev, seed, model="v1", group=None):
    """One bf16 kernel-path training step of ``model``'s repo config (the
    plain step for V4 and DispNetC), data-parallel over ``group`` where
    given."""
    plain = model in PLAIN_MODELS
    cfg = load_config(PLAIN_MODELS[model] if plain else bench.MODELS[model][0])
    model, tx, _, state = create_train_state(cfg, seed=seed, device=dev)
    step = (make_train_step(model, tx, cfg.train.loss.parameters,
                            dtype=torch.bfloat16, group=group) if plain
            else make_fast_train_step(model, tx, cfg.train.loss.parameters,
                                      group=group))
    h, w = cfg.data.image_size
    # scenes up to 96 px of disparity at 640 px wide, as wide at 320
    data = SyntheticBatches(cfg.train.batch_size, (h, w), seed0=seed,
                            max_disp=96.0 * w / 640, device=dev)
    batch = next(iter(data))[1:]
    return lambda: step(state, *batch)


def profile_device(run, frames: int) -> dict:
    """``run()`` ``frames`` times under ``torch.profiler`` after two
    warm-up calls: device ms, launches per call and route
    (:func:`kernel_route`) by :func:`kernel_group`, the narrow pairs'
    kernels by route, the device ms per call in all and the span from the
    first kernel's start to the last one's end, per call."""
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(frames):
            run()
        torch.cuda.synchronize()

    time_us = collections.Counter()
    count = collections.Counter()
    collective_us, collectives = 0.0, 0
    routes = {}
    narrow_us = collections.Counter()  # by route, pairs other than 32 -> 32
    narrow_n = collections.Counter()
    starts, ends = [], []
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CPU
                and evt.name.startswith("c10d::")):  # a collective's host op
            collective_us += evt.time_range.elapsed_us()
            collectives += 1
        # device kernels only: a user annotation (the optimizer's step
        # range) spans kernels that are counted themselves
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)
                or evt.name.startswith("Optimizer.")):
            continue
        group = kernel_group(evt.name)
        time_us[group] += evt.time_range.elapsed_us()
        count[group] += 1
        route = kernel_route(evt.name)
        routes.setdefault(group, set()).add(route)
        if route and not group.endswith(" 32->32"):
            narrow_us[route] += evt.time_range.elapsed_us()
            narrow_n[route] += 1
        starts.append(evt.time_range.start)
        ends.append(evt.time_range.end)
    if not time_us:
        raise RuntimeError("the profiler recorded no device kernels")
    groups = {g: {"ms_per_frame": t / 1e3 / frames,
                  "launches_per_frame": count[g] / frames,
                  "route": " + ".join(sorted(r or "plain"
                                             for r in routes[g]))}
              for g, t in time_us.most_common()}
    narrow = {r: {"ms_per_frame": narrow_us[r] / 1e3 / frames,
                  "launches_per_frame": narrow_n[r] / frames}
              for r in ("tensor cores", "cuda cores")}
    return {"device_ms_per_frame": sum(time_us.values()) / 1e3 / frames,
            "span_ms_per_frame": (max(ends) - min(starts)) / 1e3 / frames,
            "groups": groups, "narrow_pairs": narrow,
            "collectives": {"per_frame": collectives / frames,
                            "host_ms_per_frame": collective_us / 1e3 / frames}}


def profile_frames(frames: int = 8, seed: int = 0, train: bool = False,
                   model: str = "v1", group=None) -> dict:
    dev = torch.device("cuda", 0)
    run = (train_step_fn(dev, seed, model, group) if train
           else frame_fn(dev, seed, model))
    prof = profile_device(run, frames)
    return {"unit": ("data-parallel train step (1 rank)" if group is not None
                     else "train step" if train else "frame"),
            "frames": frames,
            "model": model, "device": torch.cuda.get_device_name(dev),
            "device_ms_per_frame": prof["device_ms_per_frame"],
            "span_ms_per_frame": prof["span_ms_per_frame"],
            "busy_share": (prof["device_ms_per_frame"]
                           / prof["span_ms_per_frame"]),
            "groups": prof["groups"], "narrow_pairs": prof["narrow_pairs"],
            "collectives": prof["collectives"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8,
                    help="frames (or training steps) to profile")
    ap.add_argument("--train", action="store_true",
                    help="profile bf16 kernel-path training steps")
    ap.add_argument("--model", choices=sorted([*bench.MODELS, *PLAIN_MODELS]),
                    default="v1",
                    help="model of the frame or training step")
    ap.add_argument("--dp", action="store_true",
                    help="with --train: the data-parallel step as the one "
                         "rank of a NCCL group")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("frame_profile: CUDA is not available", file=sys.stderr)
        return 1
    if args.dp and not args.train:
        ap.error("--dp profiles a training step: give --train")
    if not args.dp:
        print(json.dumps(profile_frames(args.frames, train=args.train,
                                        model=args.model)))
        return 0
    init_group(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        print(json.dumps(profile_frames(args.frames, train=True,
                                        model=args.model,
                                        group=default_group())))
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
