"""Resampling ops (port of ``realtime_stereo_matcher_tpu/ops/sampling.py``).

The JAX package re-implements ``torch.nn.functional.interpolate`` with
``align_corners=False`` and no antialias as gather arithmetic; here it is
that very call (bilinear, nearest, and V4's trilinear).  The warps by a
horizontal flow map (v2's and v3's refinements warp the right view's RGB or
features by the current disparity) were plain XLA in the JAX package and are
plain PyTorch here:

* :func:`warp_by_flow_map` -- the reference's ``F.grid_sample`` warp, with
  its ``align_corners=False`` renormalization on both axes;
* :func:`warp_by_flow_map_banded` -- the same warp for flows in
  ``[0, max_shift]``, with the band contract of the JAX package's
  ``warp_by_flow_map_matmul_banded``: an output pixel whose tap offset lies
  outside the band is zero.
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


def resize_trilinear(x: torch.Tensor, out_dhw, *, d_axis: int = 1,
                     h_axis: int = 2, w_axis: int = 3):
    """Trilinear resize over (D, H, W), align_corners=False: half-pixel
    centres, a source index below 0 clamped to 0 (torch mode="trilinear",
    the JAX package's ``resize_trilinear``; reference
    model/mobile_stereo_net_v4.py:477-478)."""
    xm = torch.movedim(x, (d_axis, h_axis, w_axis), (-3, -2, -1))
    lead = xm.shape[:-3]
    y = F.interpolate(xm.reshape(1, -1, *xm.shape[-3:]), size=tuple(out_dhw),
                      mode="trilinear", align_corners=False)
    return torch.movedim(y.reshape(*lead, *y.shape[-3:]), (-3, -2, -1),
                         (d_axis, h_axis, w_axis))


def warp_by_flow_map(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``image`` (B, H, W, C) by a (B, H, W, 1) horizontal flow: sample
    at ``x - flow`` with bilinear taps and zero padding.

    The reference builds a grid ``2 * x / (W - 1) - 1`` and samples with
    ``align_corners=False``, which composes to ``x_pix = (x - flow) * W /
    (W - 1) - 0.5`` and, on the identity y axis, ``y_pix = y * H / (H - 1)
    - 0.5``; this is that ``F.grid_sample`` call.  The grid is built in
    float32 and cast to the image's dtype."""
    b, h, w, _ = image.shape
    if flow.shape[-1] != 1:
        raise ValueError(f"expected a 1-channel flow, got {tuple(flow.shape)}")
    dev = image.device
    gx = torch.arange(w, dtype=torch.float32, device=dev)
    gy = torch.arange(h, dtype=torch.float32, device=dev)
    x = gx - flow[..., 0].float()
    grid = torch.stack([2.0 * x / (w - 1.0) - 1.0,
                        (2.0 * gy / (h - 1.0) - 1.0)[:, None].expand(b, h, w)],
                       dim=-1)
    out = F.grid_sample(image.permute(0, 3, 1, 2), grid.to(image.dtype),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def _vertical_identity_blend(image: torch.Tensor) -> torch.Tensor:
    """The y half of the renormalized warp, fixed per row for a horizontal
    flow: row r blends rows floor(y_pix) and floor(y_pix) + 1 at
    ``y_pix = r * H / (H - 1) - 0.5`` (zero outside the image)."""
    h, dev = image.shape[1], image.device
    # made on the image's device: a host-to-device copy would stall the host
    y_pix = (torch.arange(h, dtype=torch.float64, device=dev)
             * (h / (h - 1.0)) - 0.5)
    y0 = torch.floor(y_pix).long()
    ty = (y_pix - y0).float()
    wa = ((1.0 - ty) * ((y0 >= 0) & (y0 < h))).to(image.dtype)
    wb = (ty * ((y0 + 1 >= 0) & (y0 + 1 < h))).to(image.dtype)
    ia = y0.clamp(0, h - 1)
    ib = (y0 + 1).clamp(0, h - 1)
    return (image.index_select(1, ia) * wa[:, None, None]
            + image.index_select(1, ib) * wb[:, None, None])


def warp_by_flow_map_banded(image: torch.Tensor, flow: torch.Tensor,
                            max_shift: int) -> torch.Tensor:
    """:func:`warp_by_flow_map` for flows in ``[0, max_shift]``.

    Output pixel x reads taps x0 = floor(x_pix) and x0 + 1; where its tap
    offset ``x - x0`` lies outside ``[-1, max_shift + 1]`` it is zero (the
    contract of the JAX package's ``warp_by_flow_map_banded`` and
    ``warp_by_flow_map_matmul_banded``, which its kernel paths of v2 and v3
    use).  The flow and the tap weights stay float32, and the flow keeps
    its gradient through the tap weights; the taps are summed in float32
    and cast to the image's dtype."""
    b, h, w, c = image.shape
    if flow.shape[-1] != 1:
        raise ValueError(f"expected a 1-channel flow, got {tuple(flow.shape)}")
    blend = _vertical_identity_blend(image)
    gx = torch.arange(w, dtype=torch.float32, device=image.device)
    x_pix = (gx - flow[..., 0].float()) * (w / (w - 1.0)) - 0.5
    x0f = torch.floor(x_pix)
    tx = x_pix - x0f
    x0 = x0f.long()
    off = torch.arange(w, device=image.device) - x0
    band = (off >= -1) & (off <= max_shift + 1)
    rows = torch.arange(b * h, device=image.device).view(b, h, 1) * w
    flat = blend.reshape(b * h * w, c)
    out = torch.zeros((b, h, w, c), dtype=torch.float32, device=image.device)
    for xi, wt in ((x0, 1.0 - tx), (x0 + 1, tx)):
        wt = wt * (band & (xi >= 0) & (xi < w))
        taps = flat.index_select(0, (rows + xi.clamp(0, w - 1)).reshape(-1))
        out += taps.view(b, h, w, c).float() * wt[..., None]
    return out.to(image.dtype)
