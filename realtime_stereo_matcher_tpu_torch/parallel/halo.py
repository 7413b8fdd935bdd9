"""Row halos for tensors sharded by rows over a mesh axis.

The JAX package row-shards its convolutions with ``jit`` shardings and lets
XLA's SPMD partitioner insert the halo exchanges (``sharded_infer.py``).
Here every rank holds ``h`` consecutive rows of each tensor (rank k of an
axis of n the k-th block; every level's rows divide evenly, the JAX
package's shard rule), and an op that reads across rows runs on a *haloed*
tile: its rows plus ``lo`` rows from the ranks above and ``hi`` rows from
the ranks below (:func:`exchange`), one all-gather of every rank's boundary
rows over the axis, recorded by ``parallel/distributed.py``'s recorder.  A
halo deeper than a shard takes rows from several ranks.  Outside the image
the tile gets zero rows (``fill="zeros"``: a convolution's padding) or the
first / last image row (``fill="edge"``: a resize's clamped index).

* :func:`conv2d_rows` / :func:`conv_transpose2d_rows` -- a torch conv on a
  row shard: the tile's rows are the conv's padding in H, so the conv runs
  unpadded in H and gives exactly the shard's output rows;
* :func:`resize_rows` -- ``F.interpolate`` (bilinear or nearest,
  ``align_corners=False``) by an integer factor on a row shard;
* :func:`conv_rows` / :func:`conv4x4_rows` / :func:`warp_rows` -- the
  kernel path's fused convs (K1, K2, K2-4x4) and the warps on a row shard,
  which the kernel-path forwards (``kernels/encoder.py``, ``unet.py``,
  ``refine_stack.py``) call with the axis they are given;
* :func:`row_sharded` -- a copy of a module whose ``Conv2d`` /
  ``ConvTranspose2d`` layers run :func:`conv2d_rows` /
  :func:`conv_transpose2d_rows` over the axis set by :func:`over_rows`,
  sharing the module's weights: the module's own forward, row-sharded;
* :func:`take_rows` / :func:`gather_rows` -- a shard of a replicated
  tensor, and a row-sharded tensor assembled on every rank.

An axis of one rank (:data:`ONE`, the default of the kernel-path ops)
exchanges nothing: every op here is then the op itself.
"""

from __future__ import annotations

import contextlib
import copy
import itertools

import torch
import torch.nn.functional as F
from torch import nn

from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    fused_conv4x4_s2,
    run_conv,
)
from realtime_stereo_matcher_tpu_torch.models.layers import (
    SameConv2d,
    tf_same_pad_k4s2,
)
from realtime_stereo_matcher_tpu_torch.ops.sampling import (
    _resize,
    warp_by_flow_map,
    warp_by_flow_map_banded,
)
from realtime_stereo_matcher_tpu_torch.parallel.distributed import all_gather
from realtime_stereo_matcher_tpu_torch.parallel.mesh import Axis

FILLS = ("zeros", "edge")

# the axis of one rank: every op here is then the op itself
ONE = Axis(None, 0, 1)


def _rows(x: torch.Tensor, dim: int, start: int, n: int) -> torch.Tensor:
    return x.narrow(dim, start, n)


def exchange(x: torch.Tensor, lo: int, hi: int, axis: Axis, *, dim: int,
             fill: str = "zeros", what: str = "row halo") -> torch.Tensor:
    """``x`` (this rank's ``h`` rows along ``dim``) with ``lo`` rows of the
    ranks above before it and ``hi`` rows of the ranks below after it;
    outside the image ``fill`` rows.  Every rank of ``axis`` calls it with
    the same arguments and shapes.  Each source rank's rows are one slice
    of its gathered boundary rows."""
    if fill not in FILLS:
        raise ValueError(f"fill must be one of {FILLS}, not {fill!r}")
    if lo == 0 and hi == 0:
        return x
    h, n, k = x.shape[dim], axis.size, axis.index
    top, bottom = min(hi, h), min(lo, h)
    if fill == "edge":  # the image's first and last rows are always sent
        top, bottom = max(top, 1), max(bottom, 1)
    pack = torch.cat([_rows(x, dim, 0, top), _rows(x, dim, h - bottom, bottom)],
                     dim)
    parts = (all_gather(pack, axis.group, what=what) if n > 1 else [pack])

    def span(g0: int, g1: int) -> list:
        """Global rows g0 .. g1 - 1 from the packs, a slice a source rank;
        outside the image zeros or the first / last image row."""
        out = []
        while g0 < g1:
            if g0 < 0 or g0 >= n * h:
                stop = min(g1, 0) if g0 < 0 else g1
                if fill == "zeros":
                    shape = list(x.shape)
                    shape[dim] = stop - g0
                    out.append(x.new_zeros(shape))
                else:
                    edge = (_rows(parts[0], dim, 0, 1) if g0 < 0 else
                            _rows(parts[-1], dim, top + bottom - 1, 1))
                    out.append(edge.repeat_interleave(stop - g0, dim))
            else:
                j, r = divmod(g0, h)
                stop = min(g1, (j + 1) * h)
                if r >= h - bottom:
                    idx = top + r - (h - bottom)
                elif r + stop - g0 <= top:
                    idx = r
                else:
                    raise AssertionError(f"rows {g0}..{stop} were not sent")
                out.append(_rows(parts[j], dim, idx, stop - g0))
            g0 = stop
        return out

    return torch.cat(span(k * h - lo, k * h) + [x]
                     + span((k + 1) * h, (k + 1) * h + hi), dim)


def take_rows(full: torch.Tensor, axis: Axis, *, dim: int, lo: int = 0,
              hi: int = 0, fill: str = "zeros") -> torch.Tensor:
    """This rank's rows of ``full`` (a tensor every rank holds whole), with
    ``lo`` / ``hi`` halo rows as :func:`exchange` gives them; no
    collective."""
    rows = full.shape[dim]
    if rows % axis.size:
        raise ValueError(f"{rows} rows do not split over {axis.size} ranks")
    h = rows // axis.size
    start, stop = axis.index * h - lo, (axis.index + 1) * h + hi
    inner = _rows(full, dim, max(start, 0), min(stop, rows) - max(start, 0))
    n_above, n_below = max(-start, 0), max(stop - rows, 0)
    if not (n_above or n_below):
        return inner
    if fill == "edge":
        pad_above = _rows(full, dim, 0, 1).repeat_interleave(n_above, dim)
        pad_below = _rows(full, dim, rows - 1, 1).repeat_interleave(n_below,
                                                                    dim)
    else:
        shape = list(full.shape)
        shape[dim] = n_above
        pad_above = full.new_zeros(shape)
        shape[dim] = n_below
        pad_below = full.new_zeros(shape)
    return torch.cat([pad_above, inner, pad_below], dim)


def gather_rows(local: torch.Tensor | None, axis: Axis, group, *, dim: int,
                shape, dtype, device, what: str = "gather rows"
                ) -> torch.Tensor:
    """The tensor row-sharded over ``axis`` (the first ``axis.size`` ranks
    of ``group``), whole on every rank of ``group``: one all-gather over
    ``group``, to which a rank off the axis gives zeros of the shard's
    ``shape`` and ``dtype``."""
    if group is None:
        return local
    buf = local if axis.member else torch.zeros(shape, dtype=dtype,
                                                device=device)
    parts = all_gather(buf, group, what=what)
    return torch.cat(parts[:axis.size], dim)


def conv2d_rows(x: torch.Tensor, weight, bias, axis: Axis, *, stride=(1, 1),
                padding=(0, 0), dilation=(1, 1), groups: int = 1,
                what: str = "row halo") -> torch.Tensor:
    """``F.conv2d`` (NCHW) of this rank's rows, ``padding`` symmetric per
    axis as torch's: the H padding comes from the neighbours' rows (zero at
    the image's edges), so each rank's output is its rows of the
    convolution of the whole image."""
    if axis.size == 1:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    h, kh = x.shape[2], weight.shape[2]
    if h % sh:
        raise ValueError(f"{h} rows at stride {sh}")
    lo, hi = ph, max(dh * (kh - 1) - ph - sh + 1, 0)
    tile = exchange(x, lo, hi, axis, dim=2, what=what)
    y = F.conv2d(tile, weight, bias, (sh, sw), (0, pw), (dh, dw), groups)
    return y[:, :, :h // sh]


def conv_transpose2d_rows(x: torch.Tensor, weight, bias, axis: Axis, *,
                          stride=(1, 1), padding=(0, 0),
                          output_padding=(0, 0), dilation=(1, 1),
                          groups: int = 1, what: str = "row halo"
                          ) -> torch.Tensor:
    """``F.conv_transpose2d`` (NCHW) of this rank's rows, where the whole
    image's output has ``stride`` x its rows: output row Y = s y - p + d i
    takes input rows from ``floor((d (k - 1) - p) / s)`` above to
    ``floor((s - 1 + p) / s)`` below the shard."""
    if axis.size == 1:
        return F.conv_transpose2d(x, weight, bias, stride, padding,
                                  output_padding, groups, dilation)
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    h, kh = x.shape[2], weight.shape[2]
    lo, hi = max((dh * (kh - 1) - ph) // sh, 0), (sh - 1 + ph) // sh
    tile = exchange(x, lo, hi, axis, dim=2, what=what)
    y = F.conv_transpose2d(tile, weight, bias, (sh, sw), (0, pw),
                           (0, output_padding[1]), groups, (dh, dw))
    start = sh * lo + ph
    return y[:, :, start:start + sh * h]


def resize_rows(x: torch.Tensor, out_hw, axis: Axis, *, mode: str,
                h_axis: int = 1, w_axis: int = 2) -> torch.Tensor:
    """``F.interpolate`` (``align_corners=False``) of this rank's rows to
    its ``out_hw[0]`` output rows, an integer factor of its rows up or
    down.  Upsampling u x bilinearly reads one row beyond the shard on
    either side (the image's first / last row at its edges, as the clamped
    index); downsampling and nearest read none."""
    h, out_h = x.shape[h_axis], out_hw[0]
    if axis.size == 1 or mode == "nearest" or out_h <= h:
        if out_h % h and h % out_h:
            raise ValueError(f"{h} -> {out_h} rows is no integer factor")
        return _resize(x, out_hw, h_axis, w_axis, mode)
    if out_h % h:
        raise ValueError(f"{h} -> {out_h} rows is no integer factor")
    u = out_h // h
    tile = exchange(x, 1, 1, axis, dim=h_axis, fill="edge",
                    what="resize halo")
    y = _resize(tile, (u * (h + 2), out_hw[1]), h_axis, w_axis, mode)
    return y.narrow(h_axis, u, out_h)


def conv_rows(x: torch.Tensor, spec, axis: Axis = ONE, residual=None
              ) -> torch.Tensor:
    """``run_conv(x, spec, residual)`` (K1 or K2, NHWC) of this rank's rows:
    the kernel runs on the haloed tile with its own SAME padding, and the
    shard's rows are cut from its output (a stride-1 conv with dilation d:
    d rows a side; stride 2: two rows above, so the tile starts on an even
    row)."""
    if axis.size == 1:
        return run_conv(x, spec, residual)
    h = x.shape[1]
    if spec.stride == 1:
        d = spec.dilation
        tile = exchange(x, d, d, axis, dim=1).contiguous()
        res = None if residual is None else F.pad(residual,
                                                  (0, 0, 0, 0, d, d))
        return run_conv(tile, spec, res).narrow(1, d, h).contiguous()
    if residual is not None:
        raise ValueError("a stride-2 conv takes no residual")
    tile = exchange(x, 2, 0, axis, dim=1).contiguous()
    return run_conv(tile, spec).narrow(1, 1, h // 2).contiguous()


def conv4x4_rows(x: torch.Tensor, spec, axis: Axis = ONE) -> torch.Tensor:
    """The 4x4 stride-2 TF-SAME conv (K2-4x4, NHWC) of this rank's rows:
    two rows above and one below, the shard's rows cut from the tile's
    output."""
    if axis.size == 1:
        return fused_conv4x4_s2(x, spec.w, spec.scale, spec.bias, act=spec.act)
    h = x.shape[1]
    tile = exchange(x, 2, 1, axis, dim=1).contiguous()
    y = fused_conv4x4_s2(tile, spec.w, spec.scale, spec.bias, act=spec.act)
    return y.narrow(1, 1, h // 2).contiguous()


def warp_rows(image: torch.Tensor, flow: torch.Tensor, axis: Axis = ONE,
              max_shift: int | None = None) -> torch.Tensor:
    """The warp of this rank's rows of ``image`` (NHWC) by its rows of the
    horizontal ``flow``: banded at ``max_shift``
    (``ops.warp_by_flow_map_banded``), or the plain warp for None.  The
    warp's vertical blend reads one row either side (zero outside the
    image, as the warp's own padding)."""
    if axis.size == 1:
        return (warp_by_flow_map(image, flow) if max_shift is None
                else warp_by_flow_map_banded(image, flow, max_shift))
    h = image.shape[1]
    tile = exchange(image, 1, 1, axis, dim=1, what="warp halo")
    where = dict(height=h * axis.size, row0=axis.index * h, pad=1)
    if max_shift is None:
        return warp_by_flow_map(tile, flow, **where)
    return warp_by_flow_map_banded(tile, flow, max_shift, **where)


# the axis the convs of row_sharded copies shard over (over_rows)
_AXES: list = []


@contextlib.contextmanager
def over_rows(axis: Axis):
    """Run the ``row_sharded`` copies in the block over ``axis``."""
    _AXES.append(axis)
    try:
        yield axis
    finally:
        _AXES.pop()


def _axis() -> Axis:
    if not _AXES:
        raise RuntimeError("a row-sharded module ran outside over_rows()")
    return _AXES[-1]


class RowConv2d(nn.Module):
    """A ``Conv2d`` (or the v3 U-Net's TF-SAME ``SameConv2d``) run on the
    row shard of the axis in force (:func:`over_rows`)."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        axis, c = _axis(), self.conv
        if axis.size == 1:
            return c(x)
        if isinstance(c, SameConv2d):  # TF-SAME: (1, 1) rows at even H
            left, right = tf_same_pad_k4s2(x.shape[-1])
            return conv2d_rows(F.pad(x, (left, right, 0, 0)), c.weight,
                               c.bias, axis, stride=c.stride, padding=(1, 0),
                               dilation=c.dilation, groups=c.groups)
        if c.padding_mode != "zeros" or isinstance(c.padding, str):
            raise NotImplementedError(f"row sharding of {c}")
        return conv2d_rows(x, c.weight, c.bias, axis, stride=c.stride,
                           padding=c.padding, dilation=c.dilation,
                           groups=c.groups)


class RowConvTranspose2d(nn.Module):
    """A ``ConvTranspose2d`` run on the row shard of the axis in force."""

    def __init__(self, conv: nn.ConvTranspose2d):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        axis, c = _axis(), self.conv
        if axis.size == 1:
            return c(x)
        return conv_transpose2d_rows(
            x, c.weight, c.bias, axis, stride=c.stride, padding=c.padding,
            output_padding=c.output_padding, dilation=c.dilation,
            groups=c.groups)


def row_sharded(module: nn.Module) -> nn.Module:
    """A copy of ``module`` that shares its parameters and buffers, with
    every ``Conv2d`` and ``ConvTranspose2d`` wrapped to run on a row shard
    (:class:`RowConv2d`, :class:`RowConvTranspose2d`).  The copy runs only
    inside :func:`over_rows`; its own forward is the module's.  Every other
    layer of the module must act on each row alone (BatchNorm in eval mode,
    activations, 1 x 1 maps, channel concats)."""
    memo = {id(t): t for t in itertools.chain(module.parameters(),
                                              module.buffers())}
    twin = copy.deepcopy(module, memo)
    for parent in list(twin.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.Conv2d):
                setattr(parent, name, RowConv2d(child))
            elif isinstance(child, nn.ConvTranspose2d):
                setattr(parent, name, RowConvTranspose2d(child))
    return twin
