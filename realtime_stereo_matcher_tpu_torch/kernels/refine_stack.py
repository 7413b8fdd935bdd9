"""RefineNet cascade on the fused 3x3 kernel (port of the v1 branch of
``realtime_stereo_matcher_tpu/kernels/refine_stack.py``).

One RefineNet is 14 fused 3x3 convs: the entry conv (disparity + RGB, 4 ->
32), six dilated ResBlocks of two convs each (1, 2, 4, 8, 1, 1), and a head
conv 32 -> 1 with bias.  Weights are folded once, when the plan is built.

Precision: the disparity state is carried in float32 outside the stack (bf16
would quantize sub-pixel disparity at ~0.8 px granularity); inside the stack
activations are in the plan's dtype with float32 accumulation, and the final
``relu(disp + delta)`` runs in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    ConvSpec,
    conv_spec,
    convbn_spec,
    run_conv,
)
from realtime_stereo_matcher_tpu_torch.ops import resize_bilinear


@dataclasses.dataclass(frozen=True)
class RefinePlan:
    """The folded conv stack of one RefineNet."""

    specs: tuple  # tuple[ConvSpec, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.specs[0].w.dtype


def build_refine_plan(refine, *, dtype=torch.bfloat16) -> RefinePlan:
    """Fold a port ``RefineNet`` (``conv0``: ConvBN, ResBlocks, head conv)
    into a kernel plan.  ``res_from`` points each ResBlock's second conv at
    the block's input in the activation history."""
    seq = refine.conv0
    specs: list[ConvSpec] = [convbn_spec(seq[0], dtype=dtype)]
    for block in list(seq)[1:-1]:
        block_in = len(specs)  # history index of this ResBlock's input
        specs.append(convbn_spec(block.conv[0], dtype=dtype))
        specs.append(convbn_spec(block.conv[1], dtype=dtype, res_from=block_in))
    specs.append(conv_spec(seq[-1], None, dtype=dtype, act="none"))
    return RefinePlan(tuple(specs))


def run_refine_stack(x: torch.Tensor, specs: Sequence[ConvSpec]) -> torch.Tensor:
    """Run the folded conv stack on an NHWC activation; returns the head's
    output (the residual-disparity delta, 1 channel)."""
    history = [x]
    for spec in specs:
        res = history[spec.res_from] if spec.res_from is not None else None
        history.append(run_conv(history[-1], spec, residual=res))
    return history[-1]


def fast_refine(disp: torch.Tensor, l_guide: torch.Tensor,
                plan: RefinePlan) -> torch.Tensor:
    """Kernel-path RefineNet (v1, no warped guidance): 2x-upsample the
    disparity, concat the left guide, run the conv stack, ReLU-add.

    ``disp`` (B, h, w, 1) float32, ``l_guide`` (B, H, W, 3); returns
    (B, 2h, 2w, 1) float32."""
    h2, w2 = disp.shape[1] * 2, disp.shape[2] * 2
    disp = resize_bilinear(disp.float(), (h2, w2)) * 2.0
    if l_guide.shape[1:3] != (h2, w2):
        l_guide = resize_bilinear(l_guide, (h2, w2))
    x = torch.cat([disp.to(plan.dtype), l_guide.to(plan.dtype)], dim=-1)
    delta = run_refine_stack(x.contiguous(), plan.specs)
    return torch.relu(disp + delta.float())
