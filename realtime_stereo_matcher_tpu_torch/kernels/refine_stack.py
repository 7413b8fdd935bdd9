"""RefineNet cascade on the fused 3x3 kernel (port of
``realtime_stereo_matcher_tpu/kernels/refine_stack.py``).

A v1 RefineNet is 14 fused 3x3 convs: the entry conv (disparity + RGB, 4 ->
32), six dilated ResBlocks of two convs each (1, 2, 4, 8, 1, 1), and a head
conv 32 -> 1 with bias.

v2 and v3 RefineNets warp the right guidance by the upsampled disparity
before the concat, with the banded warp (``ops.warp_by_flow_map_banded``) at
the level's ``max_shift``.  A v2 entry sees ``disp ‖ left RGB ‖ warped right
RGB``, 7 channels: one 7 -> 32 fused conv, 14 launches in all, as v1.

The plan picks the entry by its input channels, as the JAX plan does
(``entry_channels``): up to 32, one fused conv.  Wider, v3's 65 channels
``disp ‖ l_fmap ‖ warped r_fmap``, it is split by input channel,
conv(concat(d, l, r)) = conv_d(d) + conv_l(l) + conv_r(r), with the
BatchNorm scale folded into each part (JAX refine_stack.py:139-156,
:269-283): two fused 32 -> 32 convs, the second taking the BatchNorm bias
and the first's output as its residual, plus the 1-channel disparity tap as
a plain 3x3 conv, then ReLU.  With the 13 convs after it that is 15 kernel
launches.

The JAX package warps with two plain XLA functions: the static-shift
``warp_by_flow_map_banded`` for guidance of <= 8 channels at ``max_shift``
<= 64 (v2's coarse level) and the selection-matrix
``warp_by_flow_map_matmul_banded`` for the others, both chosen for the
TPU's cost model and both zero outside tap offsets ``[-1, max_shift + 1]``.
The port's one gather-based banded warp has that contract and serves every
level of v2 and v3.

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

from realtime_stereo_matcher_tpu_torch import stats_dtype
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
    """The folded conv stack of one RefineNet (after its split entry where
    the entry is wider than 32 channels)."""

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
    the block's input in the activation history.  An entry conv wider than
    32 input channels (v3's 65) gets the split entry instead of an entry
    spec."""
    seq = refine.conv0
    entry, specs = None, []
    if seq[0][0].in_channels > 32:
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


def refine_inputs(disp, l_guide, r_guide, max_shift, dtype):
    """A RefineNet's inputs: the float32 (float64 for float64) disparity
    2x-upsampled, and the guides at its size in ``dtype``, the right one
    (if any) warped by it with the banded warp at ``max_shift``.  Returns
    (disp, [guides])."""
    h2, w2 = disp.shape[1] * 2, disp.shape[2] * 2
    disp = resize_bilinear(disp.to(stats_dtype(disp.dtype)), (h2, w2)) * 2.0
    guides = [l_guide] if r_guide is None else [l_guide, r_guide]
    guides = [(g if g.shape[1:3] == (h2, w2)
               else resize_bilinear(g, (h2, w2))).to(dtype) for g in guides]
    if r_guide is not None:
        guides[1] = warp_by_flow_map_banded(guides[1], disp, max_shift)
    return disp, guides


def fast_refine(disp: torch.Tensor, l_guide: torch.Tensor, plan: RefinePlan,
                r_guide: torch.Tensor | None = None,
                max_shift: int | None = None) -> torch.Tensor:
    """Kernel-path RefineNet: :func:`refine_inputs` (with the right guide
    where one is given: v2, v3), then the entry and the conv stack,
    ReLU-add.

    ``disp`` (B, h, w, 1) float32; ``l_guide`` and ``r_guide`` (B, H, W, C)
    (RGB for v1 and v2, 32-channel features for v3); returns (B, 2h, 2w, 1)
    float32."""
    disp, guides = refine_inputs(disp, l_guide, r_guide, max_shift,
                                 plan.dtype)
    e = plan.entry
    if e is None:
        x = torch.cat([disp.to(plan.dtype), *guides], dim=-1)
    else:
        p1 = run_conv(guides[0].contiguous(), e.left)
        p2 = run_conv(guides[1].contiguous(), e.right, residual=p1)
        d = F.conv2d(disp.permute(0, 3, 1, 2), e.w_d, padding=1)
        x = torch.relu(p2.float() + d.permute(0, 2, 3, 1)).to(plan.dtype)
    delta = run_refine_stack(x.contiguous(), plan.specs)
    return torch.relu(disp + delta.float())
