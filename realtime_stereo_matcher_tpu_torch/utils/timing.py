"""Forward latency of a model at one input shape (port of
``realtime_stereo_matcher_tpu/utils/timing.py``).

On a CUDA device the time is read by CUDA events around ``iters`` forwards
queued back to back after ``warmup`` ones: the device's time per forward,
the host's too where it issues launches more slowly than the device runs
them.  On the CPU, where PyTorch runs each op to its end before returning,
``time.perf_counter`` around the same loop measures the same thing.

The JAX package's delta-K chain (each forward fed an epsilon of the last
one's output, ``t_K - t_1`` over ``K - 1``) exists only because its TPU was
reached through a relay that acknowledged ``block_until_ready`` before the
device had finished.  CUDA events are recorded on the stream itself, so no
chain is needed here.
"""

from __future__ import annotations

import time

import torch


@torch.no_grad()
def forward_latency(forward, left, right, *, iters: int = 10,
                    warmup: int = 3) -> float:
    """Seconds per call of ``forward(left, right)`` on the inputs' device,
    over ``iters`` calls after ``warmup`` untimed ones."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, not {iters}")
    for _ in range(warmup):
        forward(left, right)
    if left.device.type == "cuda":
        stream = torch.cuda.current_stream(left.device)
        stream.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(iters):
            forward(left, right)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        forward(left, right)
    return (time.perf_counter() - t0) / iters
