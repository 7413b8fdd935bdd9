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
FPS).  The JAX package's ``measure_sharded_latency`` waits for sharded
inference (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

import torch

from realtime_stereo_matcher_tpu_torch import bench, resolve_device
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.fast_infer import make_fast_forward
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


def _model(name: str, device, seed: int = 0):
    """``bench.py``'s model ``name`` with weights drawn from ``seed``."""
    return build_model(bench.model_config(name), device=resolve_device(device),
                       generator=torch.Generator().manual_seed(seed))


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
    ap.add_argument("--model", choices=sorted(bench.MODELS), default="v1")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image_hw", type=int, nargs=2, default=(720, 1280))
    ap.add_argument("--frames_per_device", type=int, default=2)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    kw = dict(image_hw=tuple(args.image_hw),
              frames_per_device=args.frames_per_device, iters=args.iters)
    if ENV_NUM_PROCESSES not in os.environ:
        for n, r in scaling_efficiency(model=args.model, device=args.device,
                                       **kw).items():
            print(f"devices={n:3d}  fps={r['fps']:8.2f}  "
                  f"efficiency={r['efficiency']:.3f}", flush=True)
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
        fps = measure_throughput(_model(args.model, device), device=device,
                                 group=group, **kw)
        if rank == 0:
            print(json.dumps({"fps": fps}), flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
