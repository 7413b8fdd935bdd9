"""Resampling ops (port of ``realtime_stereo_matcher_tpu/ops/sampling.py``).

The JAX package re-implements ``torch.nn.functional.interpolate`` with
``align_corners=False`` and no antialias as gather arithmetic; here it is
that very call.  Only the two resizes of the v1 path are ported so far.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _resize(x: torch.Tensor, out_hw, h_axis: int, w_axis: int, mode: str):
    """``F.interpolate`` over axes (h_axis, w_axis) of any-rank ``x``."""
    xm = torch.movedim(x, (h_axis, w_axis), (-2, -1))
    lead = xm.shape[:-2]
    y = F.interpolate(xm.reshape(1, -1, *xm.shape[-2:]), size=tuple(out_hw),
                      mode=mode,
                      **({} if mode == "nearest" else {"align_corners": False}))
    return torch.movedim(y.reshape(*lead, *y.shape[-2:]), (-2, -1),
                         (h_axis, w_axis))


def resize_nearest(x: torch.Tensor, out_hw, *, h_axis: int = 1, w_axis: int = 2):
    """Nearest-neighbour resize (torch F.interpolate default mode)."""
    return _resize(x, out_hw, h_axis, w_axis, "nearest")


def resize_bilinear(x: torch.Tensor, out_hw, *, h_axis: int = 1, w_axis: int = 2):
    """Bilinear resize, align_corners=False, no antialias (torch semantics)."""
    return _resize(x, out_hw, h_axis, w_axis, "bilinear")
