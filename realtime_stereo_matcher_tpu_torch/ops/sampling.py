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
  outside the band is zero;
* :func:`grid_sample_2d` -- the JAX package's ``grid_sample`` replacement,
  a bilinear sample at pixel coordinates with zero padding, on no model's
  path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _up2_transpose(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The transpose of the exact 2x bilinear upsample (align_corners=False)
    along ``dim`` (negative) of ``g``: output 2k reads 0.25 of input k - 1
    and 0.75 of k, output 2k + 1 0.75 of k and 0.25 of k + 1, the taps past
    an edge clamped onto it.  Elementwise over slices: no atomics."""
    ge, go = g.unflatten(dim, (-1, 2)).unbind(dim)
    n = ge.shape[dim]
    ge_next = torch.cat([ge.narrow(dim, 1, n - 1), go.narrow(dim, n - 1, 1)],
                        dim)
    go_prev = torch.cat([ge.narrow(dim, 0, 1), go.narrow(dim, 0, n - 1)],
                        dim)
    return 0.75 * (ge + go) + 0.25 * (ge_next + go_prev)


class _Upsample2x(torch.autograd.Function):
    """``F.interpolate(mode="bilinear", align_corners=False)`` to twice the
    size of (N, C, h, w) ``x``, the same values, with a backward that sums
    in a fixed order: CUDA's ``upsample_bilinear2d_backward`` adds with
    atomics, so two runs of a training step gave other bits in most
    gradients (the refinements' disparity upsample)."""

    @staticmethod
    def forward(ctx, x):
        return F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]),
                             mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, g):
        wide = torch.promote_types(g.dtype, torch.float32)
        return _up2_transpose(_up2_transpose(g.to(wide), -1), -2).to(g.dtype)


def _resize(x: torch.Tensor, out_hw, h_axis: int, w_axis: int, mode: str):
    """``F.interpolate`` over axes (h_axis, w_axis) of any-rank ``x`` (an
    exact 2x bilinear upsample that needs a gradient: :class:`_Upsample2x`,
    the same values)."""
    xm = torch.movedim(x, (h_axis, w_axis), (-2, -1))
    lead, hw = xm.shape[:-2], xm.shape[-2:]
    x4 = xm.reshape(1, -1, *hw)
    if (mode == "bilinear" and tuple(out_hw) == (2 * hw[0], 2 * hw[1])
            and x.requires_grad and torch.is_grad_enabled()):
        y = _Upsample2x.apply(x4)
    else:
        y = F.interpolate(x4, size=tuple(out_hw), mode=mode,
                          **({} if mode == "nearest"
                             else {"align_corners": False}))
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


def grid_sample_2d(image: torch.Tensor, x_pix: torch.Tensor,
                   y_pix: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``image`` (B, H, W, C) at pixel coordinates, zero
    outside the image: ``F.grid_sample(mode="bilinear",
    padding_mode="zeros", align_corners=False)`` at the normalized grid
    ``x_pix = ((gx + 1) * W - 1) / 2`` (and y alike), as the JAX package's
    ``grid_sample_2d`` computes it: four taps gathered, each out-of-bounds
    tap 0, then lerped along x and along y in the image's dtype.

    Args:
      image: (B, H, W, C).
      x_pix, y_pix: (B, H', W') sample locations in pixels.
    Returns:
      (B, H', W', C).
    """
    b, h, w, c = image.shape
    x0f, y0f = torch.floor(x_pix), torch.floor(y_pix)
    tx = (x_pix - x0f).to(image.dtype)[..., None]
    ty = (y_pix - y0f).to(image.dtype)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    flat = image.reshape(b, h * w, c)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat.gather(1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        return vals.reshape(*yi.shape, c) * valid[..., None].to(image.dtype)

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = v00 + tx * (v01 - v00)
    bot = v10 + tx * (v11 - v10)
    return top + ty * (bot - top)


def warp_by_flow_map(image: torch.Tensor, flow: torch.Tensor, *,
                     height: int | None = None, row0: int = 0,
                     pad: int = 0) -> torch.Tensor:
    """Warp ``image`` (B, H, W, C) by a (B, H, W, 1) horizontal flow: sample
    at ``x - flow`` with bilinear taps and zero padding.

    The reference builds a grid ``2 * x / (W - 1) - 1`` and samples with
    ``align_corners=False``, which composes to ``x_pix = (x - flow) * W /
    (W - 1) - 0.5`` and, on the identity y axis, ``y_pix = y * H / (H - 1)
    - 0.5``; this is that ``F.grid_sample`` call.  The grid is built in
    float32 and cast to the image's dtype.

    ``height``, ``row0`` and ``pad`` take a row tile of a taller image:
    ``image`` holds the image's rows from ``row0`` with ``pad`` rows of the
    image's (or zeros) on either side (``parallel/halo.py``), and ``flow``
    the inner rows.  The y grid is then the whole image's, made relative
    to the tile's rows."""
    b, rows, w, _ = flow.shape
    if flow.shape[-1] != 1:
        raise ValueError(f"expected a 1-channel flow, got {tuple(flow.shape)}")
    h, dev, dt = height or rows, image.device, image.dtype
    gx = torch.arange(w, dtype=torch.float32, device=dev)
    gy = torch.arange(row0, row0 + rows, dtype=torch.float32, device=dev)
    xn = (2.0 * (gx - flow[..., 0].float()) / (w - 1.0) - 1.0).to(dt)
    yn = (2.0 * gy / (h - 1.0) - 1.0).to(dt)
    if height is not None:  # grid_sample's y pixel, then the tile's grid
        iy = ((yn + 1) * h - 1) / 2 - (row0 - pad)
        yn = (2 * iy + 1) / image.shape[1] - 1
    grid = torch.stack([xn, yn[:, None].expand(b, rows, w)], dim=-1)
    out = F.grid_sample(image.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1)


def _vertical_identity_blend(image: torch.Tensor, height: int | None = None,
                             row0: int = 0, pad: int = 0) -> torch.Tensor:
    """The y half of the renormalized warp, fixed per row for a horizontal
    flow: row r blends rows floor(y_pix) and floor(y_pix) + 1 at
    ``y_pix = r * H / (H - 1) - 0.5`` (zero outside the image).

    ``image`` may be a row tile of an image of ``height`` rows: its rows
    ``pad .. -pad`` are the image's rows from ``row0``, with ``pad`` rows of
    the image's (or zeros) on either side (``parallel/halo.py``)."""
    rows, dev = image.shape[1] - 2 * pad, image.device
    h = height or rows
    # made on the image's device: a host-to-device copy would stall the host
    y_pix = (torch.arange(row0, row0 + rows, dtype=torch.float64, device=dev)
             * (h / (h - 1.0)) - 0.5)
    y0 = torch.floor(y_pix).long()
    ty = (y_pix - y0).float()
    wa = ((1.0 - ty) * ((y0 >= 0) & (y0 < h))).to(image.dtype)
    wb = (ty * ((y0 + 1 >= 0) & (y0 + 1 < h))).to(image.dtype)
    ia = y0.clamp(0, h - 1) - (row0 - pad)
    ib = (y0 + 1).clamp(0, h - 1) - (row0 - pad)
    return (image.index_select(1, ia) * wa[:, None, None]
            + image.index_select(1, ib) * wb[:, None, None])


def warp_by_flow_map_banded(image: torch.Tensor, flow: torch.Tensor,
                            max_shift: int, *, height: int | None = None,
                            row0: int = 0, pad: int = 0) -> torch.Tensor:
    """:func:`warp_by_flow_map` for flows in ``[0, max_shift]``.

    Output pixel x reads taps x0 = floor(x_pix) and x0 + 1; where its tap
    offset ``x - x0`` lies outside ``[-1, max_shift + 1]`` it is zero (the
    contract of the JAX package's ``warp_by_flow_map_banded`` and
    ``warp_by_flow_map_matmul_banded``, which its kernel paths of v2 and v3
    use).  The flow and the tap weights stay float32, and the flow keeps
    its gradient through the tap weights; the taps are summed in float32
    and cast to the image's dtype.  ``height``, ``row0`` and ``pad`` take a
    row tile of a taller image (:func:`_vertical_identity_blend`); ``flow``
    then has the tile's inner rows."""
    if flow.shape[-1] != 1:
        raise ValueError(f"expected a 1-channel flow, got {tuple(flow.shape)}")
    blend = _vertical_identity_blend(image, height, row0, pad)
    b, h, w, c = blend.shape
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

