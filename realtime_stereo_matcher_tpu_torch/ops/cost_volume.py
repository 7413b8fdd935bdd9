"""Cost-volume builders (port of ``realtime_stereo_matcher_tpu/ops/cost_volume.py``).

Every volume is one gather over a (D, W) index grid with a validity mask,
vectorized over the disparity axis.  Layout is channels-last:

* feature maps:            (B, H, W, C)
* 4D volumes (w/ channels): (B, D, H, W, C)
* 3D volumes:              (B, D, H, W)

The difference volume's invalid region (``x < d``) is filled with 1.0, as
in the reference (model/mobile_stereo_net.py:13-22); the correlation,
concatenation and group-wise volumes' with 0.0 (reference
model/mobile_disp_net_c.py:191, cost_volume/*.py).  The concatenation and
group-wise volumes are on no model's path (the reference's dormant
cost-volume library, as in the JAX package).

MobileDispNetC's correlation and MobileStereoNetV4's regression head
(:func:`soft_argmin_trilinear`) were plain XLA in the JAX package and are
plain PyTorch here.  The JAX head never materializes the upsampled volume,
for the TPU's memory; here the (B, D, H, W) float32 logits are made and
autograd runs through them (1.77 GB at V4's training shape, 4 heads x batch
6 x 192 x 240 x 320).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from realtime_stereo_matcher_tpu_torch import stats_dtype

# fill value of the difference volume where the shifted pixel is off-image
DIFFERENCE_FILL = 1.0


def _shift_indices(w: int, max_disp: int, device, shift0: int = 0):
    """(D, W) gather indices ``idx[d, x] = x - (shift0 + d)`` (clamped) plus
    validity."""
    idx = (torch.arange(w, device=device)[None, :]
           - torch.arange(shift0, shift0 + max_disp, device=device)[:, None])
    valid = idx >= 0
    return idx.clamp(min=0), valid


def shift_stack(fmap: torch.Tensor, max_disp: int, shift0: int = 0):
    """Stack right-image features over disparity shifts.

    Args:
      fmap: (B, H, W, C) right-image features.
      max_disp: number of disparity hypotheses D.
      shift0: the first shift (a slab of the shifts).

    Returns:
      (stack, valid): stack (B, D, H, W, C) with
      ``stack[:, d, :, x] = fmap[:, :, x - shift0 - d]`` (clamped), and
      valid (1, D, 1, W, 1) boolean mask of in-bounds shifts.
    """
    w = fmap.shape[2]
    idx, valid = _shift_indices(w, max_disp, fmap.device, shift0)
    g = fmap[:, :, idx]                     # (B, H, D, W, C)
    return g.permute(0, 2, 1, 3, 4), valid[None, :, None, :, None]


def difference_cost_volume(left: torch.Tensor, right: torch.Tensor,
                           max_disp: int, *, shift0: int = 0) -> torch.Tensor:
    """StereoNet-style difference volume (reference model/mobile_stereo_net.py:8-27).

    Args:
      left, right: (B, H, W, C) features.
      shift0: the first shift: the slab of shifts ``[shift0, shift0 +
        max_disp)`` (``parallel/disparity_sharding.py``).
    Returns:
      (B, D, H, W, C); entries with ``x < d`` are 1.0 (reference fill value).
    """
    shifted, valid = shift_stack(right, max_disp, shift0)
    return (left[:, None] - shifted).masked_fill(~valid, DIFFERENCE_FILL)


def concat_cost_volume(left: torch.Tensor, right: torch.Tensor,
                       max_disp: int) -> torch.Tensor:
    """Concatenation volume (reference cost_volume/concatenate.py:11-41).

    Args:
      left, right: (B, H, W, C) features.
    Returns:
      (B, D, H, W, 2C): ``[..., :C]`` the left features, ``[..., C:]`` the
      right features shifted by d, both 0 where ``x < d``.
    """
    shifted, valid = shift_stack(right, max_disp)
    both = torch.cat([left[:, None].expand_as(shifted), shifted], dim=-1)
    return both.masked_fill(~valid, 0.0)


def groupwise_cost_volume(left: torch.Tensor, right: torch.Tensor,
                          max_disp: int, n_groups: int) -> torch.Tensor:
    """Group-wise correlation volume (reference cost_volume/groupwise.py:
    12-56): ``out[b, d, h, x, g] = mean over the channels c of group g of
    left[b, h, x, c] * right[b, h, x - d, c]`` for ``x >= d``, else 0.

    The products and means are taken in float32 (float64 for float64) and
    cast back to left's dtype.

    Args:
      left, right: (B, H, W, C) features, C a multiple of ``n_groups``.
    Returns:
      (B, D, H, W, G), the reference's (N, G, H, W, D) in this layout.
    """
    b, h, w, c = left.shape
    assert c % n_groups == 0, (
        f"groupwise cost channel ({c}) % #groups ({n_groups}) != 0.")
    wide = stats_dtype(left.dtype)
    shifted, valid = shift_stack(right, max_disp)
    prod = left[:, None].to(wide) * shifted.to(wide)
    prod = prod.reshape(b, max_disp, h, w, n_groups, c // n_groups).mean(-1)
    return prod.masked_fill(~valid, 0.0).to(left.dtype)


def soft_argmin(cost: torch.Tensor, axis: int = 1, *, keepdims: bool = False):
    """Softmax-weighted expected disparity ``sum_d d * softmax(cost)[d]``.

    The softmax runs in float32 whatever ``cost``'s type (float64 for
    float64); the result is cast back to it.  Higher cost = more weight
    (reference model/mobile_stereo_net.py:144-147).
    """
    d = cost.shape[axis]
    p = torch.softmax(cost.to(stats_dtype(cost.dtype)), dim=axis)
    shape = [1] * cost.ndim
    shape[axis] = d
    disps = torch.arange(d, dtype=p.dtype, device=cost.device).reshape(shape)
    out = torch.sum(p * disps, dim=axis, keepdim=keepdims)
    return out.to(cost.dtype)


def interweave_volume(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Channel-interleaved pair (reference cost_volume/interweave.py:10-22):
    ``out[..., 2i] = left[..., i]``, ``out[..., 2i + 1] = right[..., i]``.

    Args:
      left, right: (..., C).
    Returns:
      (..., 2C).
    """
    return torch.stack([left, right], dim=-1).flatten(-2)


def correlation_cost_volume(left: torch.Tensor, right: torch.Tensor,
                            max_disp: int) -> torch.Tensor:
    """Mean-correlation volume (reference model/mobile_disp_net_c.py:188-205):
    ``out[b, d, h, x] = mean_c(left[b, h, x, c] * right[b, h, x - d, c])``
    for ``x >= d``, else 0.

    Args:
      left, right: (B, H, W, C) features.
    Returns:
      (B, D, H, W) in left's dtype; the products are summed in float32
      (float64 for float64) and scaled by 1 / C, as the JAX package's
      float32-accumulated matmul is.
    """
    b, h, w, c = left.shape
    lf, rf = (t.to(stats_dtype(t.dtype)) for t in (left, right))
    out = lf.new_zeros((b, max_disp, h, w))
    for d in range(min(max_disp, w)):
        out[:, d, :, d:] = (lf[:, :, d:] * rf[:, :, :w - d]).sum(-1) * (1.0 / c)
    return out.to(left.dtype)


def _depth_lerp(s: int, out_d: int, device):
    """Source indices i0, i1 and weights t of the linear resize of a depth
    axis of ``s`` to ``out_d`` (align_corners=False: half-pixel centres, a
    source position below 0 clamped to 0), in float32 as the JAX package's
    ``_depth_interp_weights`` computes them."""
    x = (torch.arange(out_d, dtype=torch.float32, device=device) + 0.5) * (
        s / out_d) - 0.5
    x0 = torch.floor(x.clamp(min=0.0))
    i0 = x0.long().clamp(0, s - 1)
    return i0, (i0 + 1).clamp(max=s - 1), x.clamp(min=0.0) - x0


def soft_argmin_trilinear(vol: torch.Tensor, out_d: int, out_hw) -> torch.Tensor:
    """:func:`soft_argmin` over ``vol`` (B, S, h, w) upsampled trilinearly
    to (B, ``out_d``, H, W) -- MobileStereoNetV4's regression head
    (reference model/mobile_stereo_net_v4.py:477-518; JAX
    ``soft_argmin_trilinear``).

    As in the JAX package: the spatial bilinear resize runs in ``vol``'s
    dtype (the reference upsamples under fp16 autocast), the depth lerp
    ``l0 + t * (l1 - l0)`` in float32 with the source index clamped at 0
    (align_corners=False), and the softmax and the expectation in float32
    (float64 for a float64 ``vol``; the lerp's weights stay float32).
    Bilinear and depth-linear interpolation commute, so spatial-then-depth
    is the trilinear resize.  The depth lerp gathers its two taps (CUDA's
    1D linear resize runs one thread per output position, a loop over
    every pixel, ~100 ms at 720p).

    Returns (B, H, W) float32 (float64) expected disparity.
    """
    with torch.autocast(vol.device.type, enabled=False):
        v = F.interpolate(vol, size=tuple(out_hw), mode="bilinear",
                          align_corners=False).to(stats_dtype(vol.dtype))
    return soft_argmin_depth_lerp(v, out_d)


def soft_argmin_depth_lerp(v: torch.Tensor, out_d: int) -> torch.Tensor:
    """The depth half of :func:`soft_argmin_trilinear`: ``v`` (B, S, H, W),
    already resized spatially (in float32, float64 for float64), lerped to
    ``out_d`` depths and soft-argmined.  Returns (B, H, W)."""
    i0, i1, t = _depth_lerp(v.shape[1], out_d, v.device)
    l0 = v.index_select(1, i0)
    logits = l0 + t[:, None, None] * (v.index_select(1, i1) - l0)
    return soft_argmin(logits, axis=1)
