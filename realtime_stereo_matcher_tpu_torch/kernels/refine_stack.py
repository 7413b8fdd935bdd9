"""RefineNet cascade on the fused 3x3 kernel (port of the v1 and v3 branches
of ``realtime_stereo_matcher_tpu/kernels/refine_stack.py``).

A v1 RefineNet is 14 fused 3x3 convs: the entry conv (disparity + RGB, 4 ->
32), six dilated ResBlocks of two convs each (1, 2, 4, 8, 1, 1), and a head
conv 32 -> 1 with bias.

A v3 RefineNet's entry conv sees 65 channels, ``disp ‖ l_fmap ‖ warped
r_fmap``.  It is split by input channel, conv(concat(d, l, r)) = conv_d(d) +
conv_l(l) + conv_r(r), with the BatchNorm scale folded into each part (JAX
refine_stack.py:139-156, :269-283): two fused 32 -> 32 convs, the second
taking the BatchNorm bias and the first's output as its residual, plus the
1-channel disparity tap as a plain 3x3 conv, then ReLU.  With the 13 convs
after it that is 15 kernel launches.  The right features are warped with the
banded warp (``ops.warp_by_flow_map_banded``) at the level's ``max_shift``.

Weights are folded once, when the plan is built.

Precision: the disparity state (and the warp's flow) is carried in float32
outside the stack (bf16 would quantize sub-pixel disparity at ~0.8 px
granularity); inside the stack activations are in the plan's dtype with
float32 accumulation, and the final ``relu(disp + delta)`` runs in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    ConvSpec,
    conv_spec,
    convbn_spec,
    fold_bn_scale_bias,
    plain_scale_bias,
    run_conv,
)
from realtime_stereo_matcher_tpu_torch.ops import (
    resize_bilinear,
    warp_by_flow_map_banded,
)


@dataclasses.dataclass(frozen=True)
class SplitEntry:
    """v3's 65-channel entry conv split by input channel, BatchNorm scale
    folded into each part: linear 32 -> 32 specs for the left features and
    for the warped right ones (which carries the BatchNorm bias), and the
    (32, 1, 3, 3) float32 disparity tap."""

    left: ConvSpec
    right: ConvSpec
    w_d: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RefinePlan:
    """The folded conv stack of one RefineNet (v3: after its split entry)."""

    specs: tuple  # tuple[ConvSpec, ...]
    entry: SplitEntry | None = None

    @property
    def dtype(self) -> torch.dtype:
        return self.specs[0].w.dtype


@torch.no_grad()
def _split_entry(convbn, dtype) -> SplitEntry:
    conv, bn = convbn[0], convbn[1]
    c = (conv.in_channels - 1) // 2
    scale, bias = fold_bn_scale_bias(bn.weight, bn.bias, bn.running_mean,
                                     bn.running_var, bn.eps)
    w = conv.weight.float() * scale[:, None, None, None]   # OIHW
    one, zero = plain_scale_bias(None, conv.out_channels, w.device)

    def linear(part, b):
        return ConvSpec(part.permute(2, 3, 1, 0).to(dtype).contiguous(), one,
                        b.contiguous(), act="none")

    return SplitEntry(linear(w[:, 1:1 + c], zero), linear(w[:, 1 + c:], bias),
                      w[:, :1].contiguous())


def build_refine_plan(refine, *, dtype=torch.bfloat16) -> RefinePlan:
    """Fold a port ``RefineNet`` (``conv0``: ConvBN, ResBlocks, head conv)
    into a kernel plan.  ``res_from`` points each ResBlock's second conv at
    the block's input in the activation history.  A ``warp_guidance``
    RefineNet (v3) gets the split entry instead of an entry spec."""
    seq = refine.conv0
    entry, specs = None, []
    if refine.warp_guidance:
        entry = _split_entry(seq[0], dtype)
    else:
        specs.append(convbn_spec(seq[0], dtype=dtype))
    for block in list(seq)[1:-1]:
        block_in = len(specs)  # history index of this ResBlock's input
        specs.append(convbn_spec(block.conv[0], dtype=dtype))
        specs.append(convbn_spec(block.conv[1], dtype=dtype, res_from=block_in))
    specs.append(conv_spec(seq[-1], None, dtype=dtype, act="none"))
    return RefinePlan(tuple(specs), entry)


def run_refine_stack(x: torch.Tensor, specs: Sequence[ConvSpec]) -> torch.Tensor:
    """Run the folded conv stack on an NHWC activation; returns the head's
    output (the residual-disparity delta, 1 channel)."""
    history = [x]
    for spec in specs:
        res = history[spec.res_from] if spec.res_from is not None else None
        history.append(run_conv(history[-1], spec, residual=res))
    return history[-1]


def _upsample(disp, l_guide):
    """2x-upsample the float32 disparity; the guide to its size."""
    h2, w2 = disp.shape[1] * 2, disp.shape[2] * 2
    disp = resize_bilinear(disp.float(), (h2, w2)) * 2.0
    if l_guide.shape[1:3] != (h2, w2):
        l_guide = resize_bilinear(l_guide, (h2, w2))
    return disp, l_guide


def fast_refine(disp: torch.Tensor, l_guide: torch.Tensor,
                plan: RefinePlan) -> torch.Tensor:
    """Kernel-path RefineNet (v1, no warped guidance): 2x-upsample the
    disparity, concat the left guide, run the conv stack, ReLU-add.

    ``disp`` (B, h, w, 1) float32, ``l_guide`` (B, H, W, 3); returns
    (B, 2h, 2w, 1) float32."""
    disp, l_guide = _upsample(disp, l_guide)
    x = torch.cat([disp.to(plan.dtype), l_guide.to(plan.dtype)], dim=-1)
    delta = run_refine_stack(x.contiguous(), plan.specs)
    return torch.relu(disp + delta.float())


def fast_refine_warped(disp: torch.Tensor, l_fmap: torch.Tensor,
                       r_fmap: torch.Tensor, plan: RefinePlan,
                       max_shift: int) -> torch.Tensor:
    """Kernel-path RefineNet with warped guidance (v3): 2x-upsample the
    disparity, warp the right features by it (banded at ``max_shift``), run
    the split entry and the conv stack, ReLU-add.

    ``disp`` (B, h, w, 1) float32, ``l_fmap`` / ``r_fmap`` (B, 2h, 2w, 32)
    in the plan's dtype; returns (B, 2h, 2w, 1) float32."""
    e = plan.entry
    disp, l_fmap = _upsample(disp, l_fmap)
    if r_fmap.shape[1:3] != l_fmap.shape[1:3]:
        r_fmap = resize_bilinear(r_fmap, l_fmap.shape[1:3])
    warped = warp_by_flow_map_banded(r_fmap.to(plan.dtype), disp, max_shift)
    p1 = run_conv(l_fmap.to(plan.dtype).contiguous(), e.left)
    p2 = run_conv(warped.contiguous(), e.right, residual=p1)
    d = F.conv2d(disp.permute(0, 3, 1, 2), e.w_d, padding=1)
    x = torch.relu(p2.float() + d.permute(0, 2, 3, 1)).to(plan.dtype)
    delta = run_refine_stack(x.contiguous(), plan.specs)
    return torch.relu(disp + delta.float())
