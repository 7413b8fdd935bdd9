"""Disparity-axis sharding of the cost volume (port of
``realtime_stereo_matcher_tpu/parallel/disparity_sharding.py``).

The cost volume is the memory- and compute-dominant structure of the
coarse stage, O(C * D * h * w).  Its disparity axis D is sharded over the
ranks of a ``disp`` mesh axis (``parallel/mesh.py`` :class:`Axis`): rank k
owns shifts ``[k D/n, (k + 1) D/n)`` and builds that slab of the difference
volume (``difference_cost_volume(..., shift0=)``) from the features, which every rank of the axis holds whole (they
are ~D/n times smaller than the slab).

* :func:`make_sharded_coarse_fn` -- the difference volume, the 5-layer
  3x3x3 filter and the soft-argmin of v1 / v2 / v3.  Each filter layer
  convolves across D, so it first takes one boundary slab from each
  neighbour (:func:`halo_exchange_d`, zero at the global ends), runs on
  the ``D_l + 2`` planes with its own SAME padding and keeps the inner
  ``D_l``: the same math as the one-process conv.  The layers are the
  plain ``CostFilter3D`` modules, or on the kernel path the K3 specs of
  ``kernels/cost_filter3d.py`` (``fused_conv3d`` zero-pads D itself).  The
  soft-argmin is a distributed softmax in float32 (float64 for float64):
  an all-reduce MAX of the per-pixel maximum, then one all-reduce SUM of
  ``sum(e)`` and ``sum(e * d)`` over the global shifts, and their
  quotient.
* :func:`make_sharded_v4_volume_fn` -- MobileStereoNetV4's interweave
  volume: its reducer's convolutions are spatial only, so each rank builds
  its ``(B, S/n, h, w)`` slab (``interweave_cost(..., shift0=)``) with no
  halo, and the slabs are all-gathered over the axis.

Every collective goes through ``parallel/distributed.py``, whose recorder
counts it (``parallel/comm_audit.py``).
"""

from __future__ import annotations

import torch

from realtime_stereo_matcher_tpu_torch import stats_dtype
from realtime_stereo_matcher_tpu_torch.kernels.cost_filter3d import (
    fused_conv3d,
)
from realtime_stereo_matcher_tpu_torch.models.stereo_net_v4 import (
    interweave_cost,
)
from realtime_stereo_matcher_tpu_torch.ops.cost_volume import (
    difference_cost_volume,
)
from realtime_stereo_matcher_tpu_torch.parallel.distributed import (
    all_gather,
    all_reduce_,
)
from realtime_stereo_matcher_tpu_torch.parallel.halo import exchange
from realtime_stereo_matcher_tpu_torch.parallel.mesh import Axis


def halo_exchange_d(vol: torch.Tensor, axis: Axis, *, dim: int
                    ) -> torch.Tensor:
    """``vol`` with each neighbour's boundary plane along ``dim`` (its
    D axis) before and after it, zero at the global ends: D_l -> D_l + 2."""
    return exchange(vol, 1, 1, axis, dim=dim, what="disparity halo")


def _plain_layers(cost_filter):
    """A ``CostFilter3D``'s five layers (conv, BN, ReLU; the last a conv
    with bias) as functions of NCDHW volumes."""
    mods = list(cost_filter)
    return [torch.nn.Sequential(*mods[i:i + 3]) for i in range(0, 12, 3)] + [
        mods[12]]


def make_sharded_coarse_fn(axis: Axis, max_disp: int, *, cost_filter=None,
                           specs=None):
    """``f(left_feat, right_feat) -> (B, h, w, 1)`` coarse disparity with
    the cost volume sharded over ``axis`` (every rank of it calls ``f``
    with the whole (B, h, w, C) features).

    Exactly one of ``cost_filter`` (a port ``CostFilter3D``: the plain
    path, in the features' dtype) and ``specs`` (its five folded K3
    specs, ``kernels.cost_filter3d.build_cost_filter_plan``: the kernel
    path, in the specs' dtype) is given.  The result is float32 (float64
    for a float64 cost), as ``_coarse_disparity`` returns it."""
    if (cost_filter is None) == (specs is None):
        raise ValueError("give cost_filter or specs")
    if max_disp % axis.size:
        raise ValueError(f"{max_disp} disparities over {axis.size} ranks")
    d_local = max_disp // axis.size
    d0 = (axis.index or 0) * d_local  # a rank off the axis never calls f
    layers = _plain_layers(cost_filter) if specs is None else None

    def run(x, d_dim, layer):
        if axis.size == 1:
            return layer(x)
        y = layer(halo_exchange_d(x, axis, dim=d_dim))
        return y.narrow(d_dim, 1, d_local).contiguous()

    def coarse(left, right):
        slab = difference_cost_volume(left, right, d_local, shift0=d0)
        if specs is None:
            x = slab.permute(0, 4, 1, 2, 3)            # NCDHW, D at dim 2
            for layer in layers:
                x = run(x, 2, layer)
            cost = x[:, 0]
        else:
            x = slab.to(specs[0].w.dtype).contiguous()  # NDHWC, D at dim 1
            for spec in specs:
                x = run(x, 1, lambda v, s=spec: fused_conv3d(
                    v, s.w, s.scale, s.bias, relu=s.act == "relu"))
            cost = x[..., 0].to(stats_dtype(x.dtype))
        return sharded_soft_argmin(cost, axis, d0)[..., None]

    return coarse


def sharded_soft_argmin(cost: torch.Tensor, axis: Axis, d0: int
                        ) -> torch.Tensor:
    """``soft_argmin(cost, axis=1)`` of the global volume from this rank's
    slab ``cost`` (B, D_l, h, w) of shifts ``d0 ..``: the softmax of the
    global shifts in float32 (float64 for float64), the same on every rank
    of ``axis``.  Returns (B, h, w) in that type."""
    acc = stats_dtype(cost.dtype)
    c = cost.to(acc)
    m = all_reduce_(c.amax(dim=1).contiguous(), axis.group, op="max",
                    what="soft-argmin max")
    e = torch.exp(c - m[:, None])
    dvals = torch.arange(d0, d0 + c.shape[1], dtype=acc, device=c.device)
    sums = torch.stack([e.sum(1), (e * dvals[:, None, None]).sum(1)])
    all_reduce_(sums, axis.group, what="soft-argmin sums")
    return sums[1] / sums[0]


def make_sharded_v4_volume_fn(axis: Axis, model):
    """``f(feat_l, feat_r) -> (B, S, h, w)``: MobileStereoNetV4's
    interweave volume (``model.volume_size`` shifts S) with the shifts
    sharded over ``axis``; every rank of it calls ``f`` with the whole
    (B, 32, h, w) NCHW features and gets the whole volume."""
    s_all = model.volume_size
    if s_all % axis.size:
        raise ValueError(f"{s_all} shifts over {axis.size} ranks")
    s_local = s_all // axis.size
    chunk = min(model.volume_chunk, s_local)

    def volume(feat_l, feat_r):
        slab = interweave_cost(model.conv3d, model.volume11, feat_l, feat_r,
                               s_local, chunk, shift0=axis.index * s_local)
        if axis.size == 1:
            return slab
        return torch.cat(all_gather(slab, axis.group, what="v4 volume slabs"),
                         dim=1)

    return volume
