"""Where the device time of a 720p frame, or of a training step, goes, by
kernel.

    python -m realtime_stereo_matcher_tpu_torch.frame_profile [--frames 8]
    python -m realtime_stereo_matcher_tpu_torch.frame_profile --train [--frames 4]

Builds v1 as ``bench.py`` does, runs ``--frames`` frames of the bf16 kernel
path under ``torch.profiler`` after two warm-up frames, and prints one JSON
line: per group of device kernels (each hand-written kernel by its template
shape, and the plain PyTorch ops by name) the device ms per frame and the
launches per frame, plus the device busy share over the profiled span
(kernel time / span from the first kernel's start to the last one's end).
Kernels of one stream do not overlap, so the sum is the busy time.

With ``--train`` the unit is one bf16 kernel-path training step of the
reference config (``configure/stereo_net_config.json``: batch 4, 480 x 640
seeded synthetic scenes, weights from the train-start init), after two
warm-up steps.
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
from realtime_stereo_matcher_tpu_torch.train.trainer import create_train_state

# rsm::conv_kernel<T, CI, CO, S, KD>
_CONV = re.compile(r"conv_kernel<([^,]+),\s*(\d+),\s*(\d+),\s*(\d+),\s*(\d+)>")
# dw_partial_kernel<T, KD, CI, CO>
_DW = re.compile(r"dw_partial_kernel<([^,]+),\s*(\d+),\s*(\d+),\s*(\d+)>")


def kernel_group(name: str) -> str:
    """A device kernel's group: the port's kernels by (kernel, C_in, C_out),
    anything else by its name up to the template arguments."""
    m = _CONV.search(name)
    if m:
        _, ci, co, s, kd = m.groups()
        kernel = ("fused_conv3d" if kd == "3" else
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


def _frame_fn(dev, seed):
    """One bf16 720p frame of the kernel path."""
    model = build_model(json.loads(bench.CONFIG.read_text())["model"],
                        device=dev, generator=torch.Generator().manual_seed(seed))
    forward = make_fast_forward(model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    left, right = (torch.rand((1, *bench.HW, 3), generator=gen, device=dev)
                   * 255 for _ in range(2))
    return lambda: forward(left, right)


def _train_step_fn(dev, seed):
    """One bf16 kernel-path training step of the reference config."""
    cfg = load_config(bench.CONFIG)
    model, tx, _, state = create_train_state(cfg, seed=seed, device=dev)
    step = make_fast_train_step(model, tx, cfg.train.loss.parameters)
    data = SyntheticBatches(cfg.train.batch_size, cfg.data.image_size,
                            seed0=seed, max_disp=96.0, device=dev)
    batch = next(iter(data))[1:]
    return lambda: step(state, *batch)


def profile_frames(frames: int = 8, seed: int = 0, train: bool = False) -> dict:
    dev = torch.device("cuda", 0)
    run = (_train_step_fn if train else _frame_fn)(dev, seed)
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
    starts, ends = [], []
    for evt in prof.events():
        # device kernels only: a user annotation (the optimizer's step
        # range) spans kernels that are counted themselves
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)
                or evt.name.startswith("Optimizer.")):
            continue
        group = kernel_group(evt.name)
        time_us[group] += evt.time_range.elapsed_us()
        count[group] += 1
        starts.append(evt.time_range.start)
        ends.append(evt.time_range.end)
    if not time_us:
        raise RuntimeError("the profiler recorded no device kernels")
    busy = sum(time_us.values())
    span = max(ends) - min(starts)
    groups = {g: {"ms_per_frame": t / 1e3 / frames,
                  "launches_per_frame": count[g] / frames}
              for g, t in time_us.most_common()}
    return {"unit": "train step" if train else "frame", "frames": frames,
            "device": torch.cuda.get_device_name(dev),
            "device_ms_per_frame": busy / 1e3 / frames,
            "span_ms_per_frame": span / 1e3 / frames,
            "busy_share": busy / span, "groups": groups}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8,
                    help="frames (or training steps) to profile")
    ap.add_argument("--train", action="store_true",
                    help="profile bf16 kernel-path training steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("frame_profile: CUDA is not available", file=sys.stderr)
        return 1
    print(json.dumps(profile_frames(args.frames, train=args.train)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
