"""Data-parallel scaling of the port's inference (port of
``realtime_stereo_matcher_tpu/parallel/scaling_bench.py``).

Measures data-parallel inference throughput at increasing rank counts and
reports ``efficiency(n) = fps(n) / (n * fps(1))``.  Each rank is one process
with one card (``parallel/distributed.py``) and runs the kernel-path forward
of ``bench.py`` (bf16; float32 on the CPU, where the kernels run their plain
versions) on ``frames_per_device`` frames a call; the time of a pass is the
slowest rank's.  One rank runs in the calling process; n > 1 ranks are
spawned as n processes of this module, which run as ranks when they find
the ``RSM_*`` env vars.

    python -m realtime_stereo_matcher_tpu_torch.parallel.scaling_bench

runs the curve over the cards of this machine (one card: the one-card
FPS), then, as the JAX package's ``main`` does, the single-image latency
of the sharded forward (``parallel/sharded_infer.py``: disparity and row
sharding, ``measure_sharded_latency``) of v1 on its bf16 kernel path and of
V4 (plain, bf16 autocast) at every rank count up to the cards, one rank
being the one-process frame.

    python -m realtime_stereo_matcher_tpu_torch.parallel.scaling_bench --sharded_latency --profile [--ranks 2]

profiles a sharded frame instead (``profile_sharded_frame``: rank 0's
device time by kernel group, the collectives, and the span a frame), over
``--ranks`` ranks (all the cards by default).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import torch

from realtime_stereo_matcher_tpu_torch import bench, frame_profile, resolve_device
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.fast_infer import make_fast_forward
from realtime_stereo_matcher_tpu_torch.parallel.sharded_infer import (
    make_sharded_infer,
)
from realtime_stereo_matcher_tpu_torch.parallel.distributed import (
    ENV_NUM_PROCESSES,
    all_reduce_,
    barrier,
    default_group,
    initialize,
    rank_and_world,
    shutdown,
    spawn_ranks,
)

# seconds a spawned group of ranks may take, start-up and build included
RANKS_TIMEOUT_S = 900.0
# the checkout's root, where the spawned ranks import this module from
ROOT = pathlib.Path(__file__).resolve().parents[2]
MODULE = "realtime_stereo_matcher_tpu_torch.parallel.scaling_bench"


def measure_throughput(model, *, image_hw=(720, 1280),
                       frames_per_device: int = 2, iters: int = 8,
                       device="cuda", group=None) -> float:
    """Frames/s of ``model``'s kernel-path forward on every rank of
    ``group`` (None: this process alone), ``frames_per_device`` random
    frames a rank a call: frames over all ranks and ``iters`` calls, over
    the slowest rank's time.  Raises unless the outputs are finite
    disparities of the frames' size."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    forward = make_fast_forward(model, dtype=dtype)
    rank, world = rank_and_world(group)
    gen = torch.Generator().manual_seed(rank)
    h, w = image_hw
    left, right = (torch.rand((frames_per_device, h, w, 3), generator=gen)
                   .mul(255).to(dev) for _ in range(2))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = forward(left, right)[-1]  # warm-up
    if out.shape != (frames_per_device, h, w, 1) or not bool(
            torch.isfinite(out).all()):
        raise RuntimeError(f"bad disparity: shape {tuple(out.shape)}")
    sync()
    barrier(group)
    t0 = time.perf_counter()
    for _ in range(iters):
        forward(left, right)
    sync()
    dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64)
    all_reduce_(dt, group, op="max", what="scaling bench time")
    return frames_per_device * world * iters / float(dt[0])


# the models of the sharded-latency curve: bench.py's, and V4
SHARDED_MODELS = ("v1", "v2", "v3", "v4")
V4_CONFIG = bench.CONFIGURE / "stereo_net_config_v4.json"


def _model(name: str, device, seed: int = 0):
    """``bench.py``'s model ``name`` (or V4's repo config for ``"v4"``)
    with weights drawn from ``seed``."""
    config = (json.loads(V4_CONFIG.read_text())["model"] if name == "v4"
              else bench.model_config(name))
    return build_model(config, device=resolve_device(device),
                       generator=torch.Generator().manual_seed(seed))


def _seeded_frame(image_hw, dev) -> tuple:
    """The seeded single-image (left, right) pair every rank runs."""
    gen = torch.Generator().manual_seed(0)
    h, w = image_hw
    return tuple(torch.rand((1, h, w, 3), generator=gen).mul(255).to(dev)
                 for _ in range(2))


def measure_sharded_latency(model, *, image_hw=(720, 1280), iters: int = 8,
                            warmup: int = 2, device="cuda",
                            group=None) -> float:
    """Seconds per single-image frame of ``model``'s sharded forward
    (``make_sharded_infer``, ``fast="auto"``: v1 / v2 / v3 on the bf16
    kernel path, V4 plain in bf16 autocast on the card) over the ranks of
    ``group`` (None: this process alone, the one-process frame): ``iters``
    frames between CUDA events after a synchronize and a barrier (host
    clock on the CPU), the slowest rank's time.  Every rank calls it with
    the same seeded frame."""
    dev = resolve_device(device)
    forward = make_sharded_infer(model)
    h, w = image_hw
    left, right = _seeded_frame(image_hw, dev)
    for _ in range(warmup):
        out = forward(left, right)[-1]
    if out.shape != (1, h, w, 1) or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"bad disparity: shape {tuple(out.shape)}")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    barrier(group)
    t0 = time.perf_counter()
    if cuda:
        start.record()
    for _ in range(iters):
        forward(left, right)
    if cuda:
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        seconds = time.perf_counter() - t0
    dt = torch.tensor([seconds / iters], dtype=torch.float64)
    all_reduce_(dt, group, op="max", what="sharded latency")
    return float(dt[0])


def profile_sharded_frame(model, *, image_hw=(720, 1280), frames: int = 4,
                          device="cuda", group=None) -> dict:
    """``frame_profile.profile_device`` of ``frames`` single-image frames of
    ``model``'s sharded forward (as :func:`measure_sharded_latency` runs
    it) on this rank of ``group`` (None: the one-process frame): device ms
    and launches a frame by kernel group (the port's kernels, the NCCL
    collectives' kernels, the copies and every other op by name), the
    collectives' count and host ms, and the span from the first kernel to
    the last.  Every rank of ``group`` calls it."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the profile reads the card's kernels")
    forward = make_sharded_infer(model)
    left, right = _seeded_frame(image_hw, dev)
    barrier(group)
    return frame_profile.profile_device(lambda: forward(left, right), frames)


def sharded_latency(device_counts=None, *, model: str = "v1",
                    image_hw=(720, 1280), iters: int = 8,
                    device="cuda") -> dict:
    """{n: seconds a frame} of ``model``'s sharded forward over n ranks,
    n = 1, 2, 3, ... up to the cards of this machine by default (n = 1
    here, n > 1 spawned)."""
    dev_type = resolve_device(device).type
    if device_counts is None:
        cards = torch.cuda.device_count() if dev_type == "cuda" else 1
        device_counts = list(range(1, cards + 1))
    results = {}
    for n in device_counts:
        if n == 1:
            results[n] = measure_sharded_latency(
                _model(model, device), image_hw=image_hw, iters=iters,
                device=device)
            continue
        outs = spawn_ranks(
            ["-m", MODULE, "--sharded_latency", "--model", model, "--device",
             dev_type, "--image_hw", *image_hw, "--iters", iters], n,
            timeout=RANKS_TIMEOUT_S, cwd=ROOT)
        results[n] = json.loads(outs[0][0].strip().splitlines()[-1])[
            "seconds"]
    return results


def sharded_profile(n: int, *, model: str = "v1", image_hw=(720, 1280),
                    frames: int = 4) -> dict:
    """Rank 0's :func:`profile_sharded_frame` over n ranks, a card each, in
    processes of their own (a profiler session can slow the host of the
    process that ran it)."""
    cmd = ["-m", MODULE, "--sharded_latency", "--profile", "--model", model,
           "--image_hw", *image_hw, "--iters", frames]
    if n == 1:
        run = subprocess.run(
            [sys.executable, *map(str, cmd), "--ranks", "1"], cwd=ROOT,
            capture_output=True, text=True, timeout=RANKS_TIMEOUT_S)
        if run.returncode:
            raise RuntimeError(f"the profile exited {run.returncode}: "
                               f"{run.stderr[-4000:]}")
        return json.loads(run.stdout.strip().splitlines()[-1])
    outs = spawn_ranks(cmd, n, timeout=RANKS_TIMEOUT_S, cwd=ROOT)
    return json.loads(outs[0][0].strip().splitlines()[-1])["profile"]


def scaling_efficiency(device_counts=None, *, model: str = "v1",
                       image_hw=(720, 1280), frames_per_device: int = 2,
                       iters: int = 8, device="cuda") -> dict:
    """fps and efficiency per rank count: {n: {"fps", "efficiency"}}.

    ``device_counts`` defaults to 1, 2, 4, ... up to the cards of this
    machine.  n = 1 runs here; n > 1 spawns n ranks of this module."""
    dev_type = resolve_device(device).type
    if device_counts is None:
        cards = torch.cuda.device_count() if dev_type == "cuda" else 1
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= cards]
    results, base = {}, None
    for n in device_counts:
        if n == 1:
            fps = measure_throughput(
                _model(model, device), image_hw=image_hw,
                frames_per_device=frames_per_device, iters=iters,
                device=device)
        else:
            outs = spawn_ranks(
                ["-m", MODULE, "--model", model, "--device", dev_type,
                 "--image_hw", *image_hw, "--frames_per_device",
                 frames_per_device, "--iters", iters], n,
                timeout=RANKS_TIMEOUT_S, cwd=ROOT)
            fps = json.loads(outs[0][0].strip().splitlines()[-1])["fps"]
        if base is None:
            base = fps / n
        results[n] = {"fps": fps, "efficiency": fps / (n * base)}
    return results


def main(argv=None) -> int:
    """Run the efficiency curve on this machine's cards; as one rank of a
    spawned group (the ``RSM_*`` env vars set) print that group's fps as a
    JSON line on rank 0."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=SHARDED_MODELS, default="v1",
                    help="the model (v4: the sharded latency only)")
    ap.add_argument("--sharded_latency", action="store_true",
                    help="only the sharded single-image latency")
    ap.add_argument("--profile", action="store_true",
                    help="profile --iters sharded frames (on the card) "
                         "instead of timing them")
    ap.add_argument("--ranks", type=int, default=None,
                    help="with --profile: the rank count (default: the "
                         "cards)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image_hw", type=int, nargs=2, default=(720, 1280))
    ap.add_argument("--frames_per_device", type=int, default=2)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    kw = dict(image_hw=tuple(args.image_hw),
              frames_per_device=args.frames_per_device, iters=args.iters)
    if ENV_NUM_PROCESSES not in os.environ:
        if args.profile:
            n = args.ranks or torch.cuda.device_count()
            prof = (profile_sharded_frame(
                _model(args.model, "cuda"), image_hw=kw["image_hw"],
                frames=args.iters) if n == 1 else sharded_profile(
                    n, model=args.model, image_hw=kw["image_hw"],
                    frames=args.iters))
            print(json.dumps(prof), flush=True)
            return 0
        if not args.sharded_latency and args.model != "v4":
            for n, r in scaling_efficiency(model=args.model,
                                           device=args.device, **kw).items():
                print(f"devices={n:3d}  fps={r['fps']:8.2f}  "
                      f"efficiency={r['efficiency']:.3f}", flush=True)
        for n, sec in sharded_latency(model=args.model, device=args.device,
                                      image_hw=kw["image_hw"],
                                      iters=args.iters).items():
            print(f"sharded single-image latency over {n} ranks: "
                  f"{sec * 1e3:.2f} ms", flush=True)
        return 0
    device = torch.device(args.device)
    if not initialize(device=device):
        raise RuntimeError("a rank of the scaling bench needs "
                           "RSM_NUM_PROCESSES > 1 and RSM_COORDINATOR")
    try:
        group = default_group()
        rank, _ = rank_and_world(group)
        if device.type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        if args.profile:
            record = {"profile": profile_sharded_frame(
                _model(args.model, device), image_hw=kw["image_hw"],
                frames=args.iters, device=device, group=group)}
        elif args.sharded_latency:
            sec = measure_sharded_latency(
                _model(args.model, device), image_hw=kw["image_hw"],
                iters=args.iters, device=device, group=group)
            record = {"seconds": sec}
        else:
            record = {"fps": measure_throughput(_model(args.model, device),
                                                device=device, group=group,
                                                **kw)}
        if rank == 0:
            print(json.dumps(record), flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
