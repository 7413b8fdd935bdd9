"""Named spans at the stage boundaries of the port's hot paths.

``with span("rsm.extract"): ...`` is ``torch.profiler.record_function`` while
a profiler runs (``torch.profiler.profile``, :func:`utils.profiler.trace`),
so each span lies on the profiler's clock beside the device operations it
launched.  With no profiler running it is one shared null context: one
check, no allocation, no dispatcher call.  It has no switch of its own.

The spans (every name starts ``rsm.``):

* ``rsm.forward`` -- a kernel-path frame (``models/fast_infer.py``);
* ``rsm.extract``, ``rsm.cost``, ``rsm.refine.<level>`` -- its stages, and
  those of the kernel-path training forward (``models/fast_train.py``); a
  replayed frame's stage holds its one ``cudaGraphLaunch``;
* ``rsm.capture`` -- the capture of a frame's stages as CUDA graphs;
* ``rsm.step``, and inside it ``rsm.loss``, ``rsm.backward``,
  ``rsm.optimizer`` -- a kernel-path training step;
* ``rsm.fetch``, ``rsm.augment`` -- the resident fetch and the batched
  augmentation on the card (``data/device_cache.py``,
  ``data/device_augment.py``).
"""

from __future__ import annotations

import contextlib
import functools

import torch

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span while a profiler runs."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


@functools.cache
def refine_span_names(levels: int) -> tuple[str, ...]:
    """``rsm.refine.0`` .. ``rsm.refine.<levels - 1>``, made once, so a
    frame or step formats no name."""
    return tuple(f"rsm.refine.{i}" for i in range(levels))


__all__ = ["refine_span_names", "span"]
