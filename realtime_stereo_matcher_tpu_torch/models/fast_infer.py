"""Kernel-path inference for MobileStereoNet v1, v2 and v3 (port of
``realtime_stereo_matcher_tpu/models/fast_infer.py``).

``make_fast_forward(model)`` returns ``forward(left, right) -> [negative
disparity maps]`` that computes ``model(left, right)`` (eval mode) with every
3x3, 4x4 and 3x3x3 convolution on the hand-written kernels.  Per frame:

* v1 and v2: 56 stride-1 3x3 launches (7 per view in the encoder, 14 per
  RefineNet; v2's three 7 -> 32 refine entries among them), 6 stride-2 3x3
  launches (3 per view) and 5 3x3x3 launches (the cost filter);
* v3: 69 stride-1 3x3 launches (12 per view in the U-Net, 15 per
  RefineNet), 6 4x4 stride-2 launches (3 per view) and 5 3x3x3 launches.

v2's refinements warp the right RGB, v3's the right features, by the
disparity with the banded warp at ``refine_max_shifts`` (the kernel path
of the JAX package does the same; ``model(..., banded_warp=True)`` is the
plain path with that warp).

Normalization, the cost volume, soft-argmin, the resizes, the warp and v3's
up-projections and 1x1 skip mixes are plain PyTorch, as they were plain XLA
in the JAX package.

Inputs are zero-padded to a multiple of 2^down_factor, exactly as the model
pads them; the TPU-only alignment pad of the JAX package is not needed.
Weights are folded once, here, in the path's dtype.

Under a profiler a frame is the span ``rsm.forward`` holding ``rsm.extract``
(normalise, pad, both views' encoder or U-Net), ``rsm.cost`` (volume, cost
filter, soft-argmin) and ``rsm.refine.0`` to ``.2`` (``utils/spans.py``).

MobileStereoNetV4 and MobileDispNetC have no kernel path, as in the JAX
package (:func:`has_kernel_path`): they run their plain forward.
"""

from __future__ import annotations

import torch

from realtime_stereo_matcher_tpu_torch.kernels.cost_filter3d import (
    build_cost_filter_plan,
    fast_cost_filter,
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
from realtime_stereo_matcher_tpu_torch.models.layers import normalize_images
from realtime_stereo_matcher_tpu_torch.models.stereo_net import (
    MobileStereoNet,
    MobileStereoNetV2,
    MobileStereoNetV3,
    _coarse_disparity,
    _full_res_nearest,
    refine_max_shifts,
)
from realtime_stereo_matcher_tpu_torch.ops import pad_to_multiple
from realtime_stereo_matcher_tpu_torch.utils.spans import (
    refine_span_names,
    span,
)


# the models with a kernel path (v1 and v2 share one)
KERNEL_PATH_MODELS = (MobileStereoNet, MobileStereoNetV2, MobileStereoNetV3)


def has_kernel_path(model) -> bool:
    """Whether ``make_fast_forward`` takes ``model`` (by its type)."""
    return type(model) in KERNEL_PATH_MODELS


def make_fast_forward(model, *, dtype=torch.bfloat16):
    """Build the kernel-path forward of a v1, v2 or v3 model (batch any,
    eval mode).

    The returned function takes NHWC uint8-range images on the model's
    device and returns 3 (B, H, W, 1) float32 negative disparity maps,
    coarse to fine."""
    if not has_kernel_path(model):
        raise NotImplementedError(
            f"the kernel path supports MobileStereoNet v1, v2 and v3, not "
            f"{type(model).__name__}; see ROADMAP.md")
    if type(model) is MobileStereoNetV3:
        return _make_fast_forward_v3(model, dtype)
    warp = type(model) is MobileStereoNetV2
    down = model.down_factor
    align = 2 ** down
    vol_disp = (model.max_disp + 1) // align
    enc_plan = build_encoder_plan(model.feature_extractor, dtype=dtype)
    cf_plan = build_cost_filter_plan(model.cost_filter, dtype=dtype)
    refine_plans = [build_refine_plan(r, dtype=dtype)
                    for r in model.refine_layer]
    shifts = refine_max_shifts(model.max_disp, down)
    refine_spans = refine_span_names(len(refine_plans))

    @torch.no_grad()
    def forward(left_img, right_img):
        with span("rsm.forward"):
            with span("rsm.extract"):
                left, orig_hw = pad_to_multiple(
                    normalize_images(left_img, dtype), align)
                right, _ = pad_to_multiple(normalize_images(right_img, dtype),
                                           align)
                lf = fast_encoder(left, enc_plan)
                rf = fast_encoder(right, enc_plan)
            with span("rsm.cost"):
                x = _coarse_disparity(lf, rf, vol_disp,
                                      lambda vol: fast_cost_filter(vol, cf_plan))
            multi_scale = []
            out_hw = left.shape[1:3]
            r_guide = right if warp else None
            for name, plan, shift in zip(refine_spans, refine_plans, shifts):
                with span(name):
                    x = fast_refine(x, left, plan, r_guide, shift)
                    multi_scale.append(_full_res_nearest(x, out_hw, orig_hw))
            return [-1.0 * m for m in multi_scale]

    return forward


def _make_fast_forward_v3(model: MobileStereoNetV3, dtype):
    down = model.down_factor
    align = 2 ** down
    vol_disp = (model.max_disp + 1) // align
    unet_plan = build_unet_plan(model.feature_extractor, dtype=dtype)
    cf_plan = build_cost_filter_plan(model.cost_filter, dtype=dtype)
    refine_plans = [build_refine_plan(r, dtype=dtype)
                    for r in model.refine_layers]
    shifts = refine_max_shifts(model.max_disp, down)
    refine_spans = refine_span_names(len(refine_plans))

    @torch.no_grad()
    def forward(left_img, right_img):
        with span("rsm.forward"):
            with span("rsm.extract"):
                left, orig_hw = pad_to_multiple(
                    normalize_images(left_img, dtype), align)
                right, _ = pad_to_multiple(normalize_images(right_img, dtype),
                                           align)
                l_py = fast_unet(left, unet_plan)
                r_py = fast_unet(right, unet_plan)
            with span("rsm.cost"):
                x = _coarse_disparity(l_py[0], r_py[0], vol_disp,
                                      lambda vol: fast_cost_filter(vol, cf_plan))
            multi_scale = []
            out_hw = left.shape[1:3]
            for i, plan in enumerate(refine_plans):
                with span(refine_spans[i]):
                    x = fast_refine(x, l_py[i + 1], plan, r_py[i + 1], shifts[i])
                    multi_scale.append(_full_res_nearest(x, out_hw, orig_hw))
            return [-1.0 * m for m in multi_scale]

    return forward
