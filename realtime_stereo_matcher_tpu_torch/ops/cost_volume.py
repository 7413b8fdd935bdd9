"""Cost-volume builders (port of ``realtime_stereo_matcher_tpu/ops/cost_volume.py``).

Every volume is one gather over a (D, W) index grid with a validity mask,
vectorized over the disparity axis.  Layout is channels-last:

* feature maps:            (B, H, W, C)
* 4D volumes (w/ channels): (B, D, H, W, C)
* 3D volumes:              (B, D, H, W)

The difference volume's invalid region (``x < d``) is filled with 1.0, as
in the reference (model/mobile_stereo_net.py:13-22).
"""

from __future__ import annotations

import torch

# fill value of the difference volume where the shifted pixel is off-image
DIFFERENCE_FILL = 1.0


def _shift_indices(w: int, max_disp: int, device):
    """(D, W) gather indices ``idx[d, x] = x - d`` (clamped) plus validity."""
    idx = (torch.arange(w, device=device)[None, :]
           - torch.arange(max_disp, device=device)[:, None])
    valid = idx >= 0
    return idx.clamp(min=0), valid


def shift_stack(fmap: torch.Tensor, max_disp: int):
    """Stack right-image features over disparity shifts.

    Args:
      fmap: (B, H, W, C) right-image features.
      max_disp: number of disparity hypotheses D.

    Returns:
      (stack, valid): stack (B, D, H, W, C) with
      ``stack[:, d, :, x] = fmap[:, :, x - d]`` (clamped), and valid
      (1, D, 1, W, 1) boolean mask of in-bounds shifts.
    """
    w = fmap.shape[2]
    idx, valid = _shift_indices(w, max_disp, fmap.device)
    g = fmap[:, :, idx]                     # (B, H, D, W, C)
    return g.permute(0, 2, 1, 3, 4), valid[None, :, None, :, None]


def difference_cost_volume(left: torch.Tensor, right: torch.Tensor,
                           max_disp: int) -> torch.Tensor:
    """StereoNet-style difference volume (reference model/mobile_stereo_net.py:8-27).

    Args:
      left, right: (B, H, W, C) features.
    Returns:
      (B, D, H, W, C); entries with ``x < d`` are 1.0 (reference fill value).
    """
    shifted, valid = shift_stack(right, max_disp)
    return (left[:, None] - shifted).masked_fill(~valid, DIFFERENCE_FILL)


def soft_argmin(cost: torch.Tensor, axis: int = 1, *, keepdims: bool = False):
    """Softmax-weighted expected disparity ``sum_d d * softmax(cost)[d]``.

    The softmax runs in float32 whatever ``cost``'s type; the result is cast
    back to it.  Higher cost = more weight (reference
    model/mobile_stereo_net.py:144-147).
    """
    d = cost.shape[axis]
    p = torch.softmax(cost.float(), dim=axis)
    shape = [1] * cost.ndim
    shape[axis] = d
    disps = torch.arange(d, dtype=torch.float32, device=cost.device).reshape(shape)
    out = torch.sum(p * disps, dim=axis, keepdim=keepdims)
    return out.to(cost.dtype)
