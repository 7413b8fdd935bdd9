"""Inference of one frame over several ranks: disparity and row sharding
(port of ``realtime_stereo_matcher_tpu/parallel/sharded_infer.py``).

MobileStereoNet v1 / v2 / v3 (:func:`make_sharded_infer`) run in stages:

* encoder -- each rank of a ``spatial`` axis (``parallel/mesh.py``) runs
  the encoder (v3: the U-Net, every pyramid level) on its rows of the
  normalized, padded images; the coarse features are then gathered whole
  to every rank;
* coarse -- the ranks of a ``disp`` axis build and filter their slab of the
  cost volume and combine at the soft-argmin
  (``parallel/disparity_sharding.py``); the coarse disparity is then the
  same on every rank;
* refines -- each rank of the ``spatial`` axis runs the RefineNets on its
  rows (v2's RGB warp and v3's feature warp read one row beyond them), and
  every level's full-resolution map is gathered whole to every rank, so
  each rank returns what the one-process forward returns.

XLA's partitioner inserted the JAX package's row halos; here
``parallel/halo.py`` exchanges them, op by op: a stride-1 conv with
dilation d takes d rows from either side, a stride-2 3x3 conv one from
above, the 4x4 TF-SAME conv one from either side, a 2x bilinear upsample
one edge row from either side.  Each axis is the first k ranks of the
group; a rank off an axis skips that stage's work but takes part in the
gathers.

Shard rules, the JAX package's: ``n_disp = gcd(D, n)`` for D disparities
(V4: its ``volume_size`` shifts) over n ranks, and the spatial shard count
the largest k <= n that divides the coarsest level's rows (``padded_h /
8``; V4 ``padded_h / 16``, its hourglass floor), so every level's rows
split evenly.  Images are normalized before they are padded, as the model
does.

``fast`` follows ``ModelRunner`` (``eval/validators.py``): ``"auto"`` runs
v1 / v2 / v3 on the kernel path on a CUDA device (each rank's encoder and
refine convs launch K1 / K2 / K2-4x4 on its haloed row tiles, its filter
layers K3 on its haloed disparity slab; ``dtype``, bf16 by default) and the
plain modules on the CPU; ``True`` the kernel path on either (the kernels'
plain versions on the CPU); ``False`` the plain modules in the model's own
type.  As in one process, the kernel path warps with the band
(``refine_max_shifts``) and the plain path without.  MobileStereoNetV4
(:func:`make_sharded_infer_v4`) has no kernel path: its extractor and
aggregation run row-sharded as the model's own modules
(``halo.row_sharded``), autocast to ``dtype`` under ``"auto"`` on a CUDA
device, and its volume is sharded over its shifts.  MobileDispNetC is not
sharded, as in the JAX package.

Every rank of the group builds the forward together (the axes' subgroups
are made collectively) and calls it with the same whole frames; a rank
outside ``ranks`` gets None.
"""

from __future__ import annotations

import math

import torch

from realtime_stereo_matcher_tpu_torch import stats_dtype
from realtime_stereo_matcher_tpu_torch.kernels.cost_filter3d import (
    build_cost_filter_plan,
)
from realtime_stereo_matcher_tpu_torch.kernels.encoder import (
    build_encoder_plan,
    fast_encoder,
)
from realtime_stereo_matcher_tpu_torch.kernels.refine_stack import (
    build_refine_plan,
    fast_refine,
)
from realtime_stereo_matcher_tpu_torch.kernels.unet import (
    build_unet_plan,
    fast_unet,
)
from realtime_stereo_matcher_tpu_torch.models.fast_infer import (
    has_kernel_path,
)
from realtime_stereo_matcher_tpu_torch.models.layers import normalize_images
from realtime_stereo_matcher_tpu_torch.models.stereo_net import (
    MobileStereoNetV2,
    MobileStereoNetV3,
    refine_max_shifts,
)
from realtime_stereo_matcher_tpu_torch.models.stereo_net_v4 import (
    ALIGN as V4_ALIGN,
    MobileStereoNetV4,
)
from realtime_stereo_matcher_tpu_torch.ops import pad_to_multiple, resize_nearest
from realtime_stereo_matcher_tpu_torch.ops.cost_volume import (
    soft_argmin_depth_lerp,
)
from realtime_stereo_matcher_tpu_torch.parallel.disparity_sharding import (
    make_sharded_coarse_fn,
    make_sharded_v4_volume_fn,
)
from realtime_stereo_matcher_tpu_torch.parallel.distributed import (
    broadcast_,
    default_group,
    rank_and_world,
)
from realtime_stereo_matcher_tpu_torch.parallel.halo import (
    gather_rows,
    over_rows,
    resize_rows,
    row_sharded,
    take_rows,
    warp_rows,
)
from realtime_stereo_matcher_tpu_torch.parallel.mesh import Axis, prefix_axis

FAST = ("auto", True, False)


def n_spatial(rows: int, n: int) -> int:
    """The largest shard count k <= n that divides ``rows`` (the coarsest
    level's rows), so that every level's rows split evenly."""
    for k in range(min(n, rows), 0, -1):
        if rows % k == 0:
            return k
    return 1


def _group_axis(ranks: int | None) -> Axis:
    world = rank_and_world(default_group())[1]
    n = world if ranks is None else ranks
    if not 1 <= n <= world:
        raise ValueError(f"ranks={ranks} in a group of {world}")
    return prefix_axis(n)


def _device(model) -> torch.device:
    return next(model.parameters()).device


# ---------------------------------------------------------------------------
# the plain RefineNet on a row shard


def _upsample_disp(disp, axis: Axis):
    """2x bilinear upsample of this rank's disparity rows, times 2."""
    h2, w2 = disp.shape[1] * 2, disp.shape[2] * 2
    return resize_rows(disp, (h2, w2), axis, mode="bilinear") * 2.0


def _guide(g, hw, axis: Axis):
    return g if g.shape[1:3] == hw else resize_rows(g, hw, axis,
                                                    mode="bilinear")


def refine_plain_rows(refine, conv0, disp, l_guide, axis: Axis,
                      r_guide=None):
    """A plain ``RefineNet``'s forward of this rank's rows (unbanded warp,
    as the one-process default); ``conv0`` is its row-sharded conv stack."""
    disp = _upsample_disp(disp, axis)
    hw = disp.shape[1:3]
    feats = [disp, _guide(l_guide, hw, axis)]
    if r_guide is not None:
        r_guide = _guide(r_guide, hw, axis)
        if refine.warp_guidance:
            r_guide = warp_rows(r_guide, disp, axis)
        feats.append(r_guide)
    x = conv0(torch.cat(feats, dim=-1).permute(0, 3, 1, 2))
    return torch.relu(disp + x.permute(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# MobileStereoNet v1 / v2 / v3


def make_sharded_infer(model, *, fast="auto", dtype=torch.bfloat16,
                       ranks: int | None = None):
    """``forward(left, right) -> [negative disparity maps]`` of ``model``
    (eval mode) over the first ``ranks`` ranks of the process group (all by
    default; one process without a group), equal to the one-process
    forward of the same path (``models/fast_infer.py`` ``make_fast_forward``
    on the kernel path, ``model(left, right)`` on the plain path).  Every
    rank of the group calls this; the ranks in ``ranks`` then call
    ``forward`` with the same whole (B, H, W, 3) frames.

    ``forward.n_disp`` is the disparity shard count and
    ``forward.n_spatial(padded_h)`` the row shard count of a padded frame
    height.  MobileDispNetC raises ``NotImplementedError``."""
    if fast not in FAST:
        raise ValueError(f"fast must be 'auto', True or False, not {fast!r}")
    if isinstance(model, MobileStereoNetV4):
        return make_sharded_infer_v4(model, fast=fast, dtype=dtype,
                                     ranks=ranks)
    if not has_kernel_path(model):
        raise NotImplementedError(
            f"{type(model).__name__}: no sharded inference (MobileDispNetC "
            "is single-chip by design, as in the JAX package: its "
            "correlation volume leaves no disparity or row extent worth "
            "sharding)")
    everyone = _group_axis(ranks)
    n, dev = everyone.size, _device(model)
    variant = ("v3" if isinstance(model, MobileStereoNetV3) else
               "v2" if isinstance(model, MobileStereoNetV2) else "v1")
    kernels = dev.type == "cuda" if fast == "auto" else fast
    down = model.down_factor
    align = 2 ** down
    vol_disp = (model.max_disp + 1) // align
    n_disp = math.gcd(vol_disp, n)
    disp_axis = prefix_axis(n_disp)
    refines = list(model.refine_layers if variant == "v3"
                   else model.refine_layer)
    if kernels:
        enc_plan = (build_unet_plan if variant == "v3" else build_encoder_plan)(
            model.feature_extractor, dtype=dtype)
        refine_plans = [build_refine_plan(r, dtype=dtype) for r in refines]
        coarse = make_sharded_coarse_fn(
            disp_axis, vol_disp,
            specs=build_cost_filter_plan(model.cost_filter, dtype=dtype))
        shifts = refine_max_shifts(model.max_disp, down)
        comp_dtype = dtype
    else:
        encoder = row_sharded(model.feature_extractor).eval()
        convs = [row_sharded(r.conv0).eval() for r in refines]
        coarse = make_sharded_coarse_fn(disp_axis, vol_disp,
                                        cost_filter=model.cost_filter)
        comp_dtype = model.cost_filter[0].weight.dtype
    disp_dtype = stats_dtype(comp_dtype) if kernels else comp_dtype

    def encode(img, sp):
        if kernels:
            return (fast_unet if variant == "v3" else fast_encoder)(
                img, enc_plan, sp)
        return encoder(img)

    def refine(i, x, guides, sp):
        if kernels:
            return fast_refine(x, guides[0], refine_plans[i], guides[1],
                               shifts[i], sp)
        return refine_plain_rows(refines[i], convs[i], x, guides[0], sp,
                                 guides[1])

    @torch.no_grad()
    def forward(left_img, right_img):
        if not everyone.member:
            return None
        left, (orig_h, orig_w) = pad_to_multiple(
            normalize_images(left_img, comp_dtype), align)
        right, _ = pad_to_multiple(normalize_images(right_img, comp_dtype),
                                   align)
        b, h, w, _ = left.shape
        sp = prefix_axis(n_spatial(h // align, n))
        hc, wc = h // align, w // align

        # stage 1: encoder on the row shards, coarse features to every rank
        pyramids = feats = (None, None)
        if sp.member:
            with over_rows(sp):
                pyramids = [encode(take_rows(img, sp, dim=1), sp)
                            for img in (left, right)]
            feats = [p[0] if variant == "v3" else p for p in pyramids]
        feats = [gather_rows(f, sp, everyone.group, dim=1,
                             shape=(b, hc // sp.size, wc, model.hidden_dim),
                             dtype=comp_dtype, device=dev,
                             what="coarse features") for f in feats]

        # stage 2: the disparity-sharded coarse stage, then on every rank
        if disp_axis.member:
            x = coarse(*feats)
        else:
            x = torch.empty((b, hc, wc, 1), dtype=disp_dtype, device=dev)
        if n_disp < n:
            broadcast_(x, everyone.group, what="coarse disparity")

        # stage 3: the refines on the row shards, each level to every rank
        levels = [None] * down
        if sp.member:
            x = take_rows(x, sp, dim=1)
            for i in range(down):
                if variant == "v3":
                    guides = (pyramids[0][i + 1], pyramids[1][i + 1])
                else:
                    guides = (take_rows(left, sp, dim=1),
                              take_rows(right, sp, dim=1)
                              if variant == "v2" else None)
                with over_rows(sp):
                    x = refine(i, x, guides, sp)
                levels[i] = resize_nearest(x * (w / x.shape[2]),
                                           (h // sp.size, w))
        out = []
        for level in levels:
            full = gather_rows(level, sp, everyone.group, dim=1,
                               shape=(b, h // sp.size, w, 1),
                               dtype=disp_dtype, device=dev,
                               what="disparity maps")
            out.append(-1.0 * full[:, :orig_h, :orig_w])
        return out

    forward.coarse_fn = coarse
    forward.n_disp = n_disp
    forward.n_spatial = lambda padded_h: n_spatial(padded_h // align, n)
    return forward


# ---------------------------------------------------------------------------
# MobileStereoNetV4


def make_sharded_infer_v4(model, *, fast="auto", dtype=torch.bfloat16,
                          ranks: int | None = None):
    """MobileStereoNetV4 over the ranks (:func:`make_sharded_infer`): the
    extractor and 1x1 squeeze row-sharded (eval-mode BatchNorm acts on each
    row), the interweave volume sharded over its shifts
    (``make_sharded_v4_volume_fn``), then ``dres``, the three hourglasses,
    ``classif3`` and the trilinear soft-argmin head row-sharded (the head's
    4x bilinear upsample reads an edge row either side).  There is no
    kernel path: ``fast=True`` raises; ``"auto"`` autocasts to ``dtype`` on
    a CUDA device, as ``ModelRunner`` runs the model."""
    if fast not in FAST:
        raise ValueError(f"fast must be 'auto', True or False, not {fast!r}")
    if fast is True:
        raise NotImplementedError("MobileStereoNetV4 has no kernel path (nor "
                                  "has it in the JAX package)")
    everyone = _group_axis(ranks)
    n, dev = everyone.size, _device(model)
    n_disp = math.gcd(model.volume_size, n)
    disp_axis = prefix_axis(n_disp)
    volume_fn = make_sharded_v4_volume_fn(disp_axis, model)
    extract = row_sharded(torch.nn.Sequential(model.feature_extraction,
                                              model.preconv11)).eval()
    aggregate = [row_sharded(m).eval() for m in (
        model.dres0, model.dres1, model.encoder_decoder1,
        model.encoder_decoder2, model.encoder_decoder3, model.classif3)]
    autocast = fast == "auto" and dev.type == "cuda"
    param_dtype = model.preconv11[-1].weight.dtype
    act = dtype if autocast else param_dtype

    def head(vol):
        dres0, dres1, ed1, ed2, ed3, classif3 = aggregate
        cost0 = dres0(vol)
        cost0 = dres1(cost0) + cost0
        return classif3(ed3(ed2(ed1(cost0))))

    @torch.no_grad()
    def forward(left_img, right_img):
        if not everyone.member:
            return None
        with torch.autocast(dev.type, dtype=dtype, enabled=autocast):
            return _forward(left_img, right_img)

    def _forward(left_img, right_img):
        left, (orig_h, orig_w) = pad_to_multiple(
            normalize_images(left_img, param_dtype), V4_ALIGN)
        right, _ = pad_to_multiple(normalize_images(right_img, param_dtype),
                                   V4_ALIGN)
        b, h, w, _ = left.shape
        sp = prefix_axis(n_spatial(h // V4_ALIGN, n))
        h4, w4 = h // 4, w // 4

        feats = (None, None)
        if sp.member:
            with over_rows(sp):
                feats = [extract(take_rows(img, sp, dim=1).permute(0, 3, 1, 2))
                         .to(act) for img in (left, right)]
        feats = [gather_rows(f, sp, everyone.group, dim=2,
                             shape=(b, 32, h4 // sp.size, w4), dtype=act,
                             device=dev, what="v4 features") for f in feats]

        if disp_axis.member:
            vol = volume_fn(*feats).to(act)
        else:
            vol = torch.empty((b, model.volume_size, h4, w4), dtype=act,
                              device=dev)
        if n_disp < n:
            broadcast_(vol, everyone.group, what="v4 volume")

        pred = None
        if sp.member:
            with over_rows(sp):
                c = head(take_rows(vol, sp, dim=2))
                with torch.autocast(dev.type, enabled=False):
                    v = resize_rows(c, (h // sp.size, w), sp, mode="bilinear",
                                    h_axis=2, w_axis=3)
                pred = soft_argmin_depth_lerp(v.to(stats_dtype(c.dtype)),
                                              model.max_disp)
        pred = gather_rows(pred, sp, everyone.group, dim=1,
                           shape=(b, h // sp.size, w),
                           dtype=stats_dtype(act), device=dev,
                           what="disparity maps")
        return [-1.0 * pred[:, :orig_h, :orig_w, None]]

    forward.volume_fn = volume_fn
    forward.n_disp = n_disp
    forward.n_spatial = lambda padded_h: n_spatial(padded_h // V4_ALIGN, n)
    return forward
