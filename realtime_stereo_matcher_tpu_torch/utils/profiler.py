"""Model capacity and tracing (port of
``realtime_stereo_matcher_tpu/utils/profiler.py``; reference
tools/profiler.py:11-26, thop MACs and fvcore FLOPs).

* :func:`count_parameters` -- the model's parameters (V4 has 64 more than
  the JAX package counts: the reference's Conv3d biases, which the JAX
  package folds into the BatchNorm running means);
* :func:`get_model_capacity` / :func:`cost_analysis` -- FLOPs of one eval
  forward (of any function) by ``torch.utils.flop_counter.FlopCounterMode``.
  That counter counts the matrix products and convolutions (2 x MACs) and
  nothing else.  The JAX package's number is XLA's post-fusion
  ``cost_analysis``, which also counts the elementwise work of the fused
  program, so the two are different quantities and are not compared;
* :func:`trace` -- ``torch.profiler`` over the block, CPU and CUDA
  activities, its Chrome trace written into ``log_dir``;
* :func:`span` -- a named span at a stage of the port's hot paths
  (``utils/spans.py``), recorded while a profiler runs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any

import torch
from torch.utils.flop_counter import FlopCounterMode

from realtime_stereo_matcher_tpu_torch.train.trainer import count_parameters
from realtime_stereo_matcher_tpu_torch.utils.spans import span


def cost_analysis(fn, *args, **kwargs) -> dict[str, Any]:
    """``{"flops": n}``: the FLOPs of ``fn(*args, **kwargs)`` run once (no
    gradient), as FlopCounterMode counts them."""
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


def get_model_capacity(model, left, right, *, verbose: bool = True):
    """(flops, params) of one plain eval forward at ``left`` / ``right``'s
    shapes; prints the reference's "GFLOPs" line when ``verbose``."""
    flops = cost_analysis(model.eval(), left, right)["flops"]
    params = count_parameters(model)
    if verbose:
        print(f"Model FLOPs: {flops / 1e9:.3f} GFLOPs | "
              f"params: {params / 1e6:.3f} M.")
    return flops, params


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present); on exit its Chrome trace is written to ``log_dir`` as
    ``trace_<pid>_<ns>.json``.  Yields the profiler.  The trace holds the
    program's ``rsm.`` spans (:func:`span`) beside the kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


__all__ = ["cost_analysis", "count_parameters", "get_model_capacity",
           "span", "trace"]
