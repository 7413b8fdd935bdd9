"""FeatureEncoder on the fused 3x3 kernels (port of
``realtime_stereo_matcher_tpu/kernels/encoder.py``).

The v1 encoder (reference model/mobile_stereo_net.py:97-101) is
``down_factor`` stages of (stride-2 conv3x3+BN+ReLU, ResBlock of two
conv3x3+BN+ReLU) and a head conv with bias: per view, 3 stride-2 launches
and 7 stride-1 launches at 720p.  Weights are folded once, when the plan is
built.  Given a row axis (``parallel/halo.py``), the same forward runs on
this rank's rows of the image, each conv on its haloed tile.
"""

from __future__ import annotations

import dataclasses

import torch

from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    ConvSpec,
    conv_spec,
    convbn_spec,
)
from realtime_stereo_matcher_tpu_torch.parallel.halo import ONE, conv_rows
from realtime_stereo_matcher_tpu_torch.parallel.mesh import Axis


@dataclasses.dataclass(frozen=True)
class EncoderPlan:
    """``down_factor`` x (stride-2 conv, ResBlock conv, ResBlock conv) + head."""

    stages: tuple   # tuple[(ConvSpec, ConvSpec, ConvSpec), ...]
    head: ConvSpec


def build_encoder_plan(encoder, *, dtype=torch.bfloat16) -> EncoderPlan:
    """Fold a port ``FeatureEncoder`` (Sequential: ConvBN at 2i, ResBlock at
    2i+1, head conv last) into a kernel plan."""
    n_stages = (len(encoder) - 1) // 2
    stages = []
    for i in range(n_stages):
        rb = encoder[2 * i + 1].conv
        stages.append((convbn_spec(encoder[2 * i], dtype=dtype),
                       convbn_spec(rb[0], dtype=dtype),
                       convbn_spec(rb[1], dtype=dtype)))
    head = conv_spec(encoder[2 * n_stages], None, dtype=dtype, act="none")
    return EncoderPlan(tuple(stages), head)


def fast_encoder(img: torch.Tensor, plan: EncoderPlan,
                 axis: Axis = ONE) -> torch.Tensor:
    """Kernel-path FeatureEncoder: (B, H, W, 3) normalized image ->
    (B, H/2^k, W/2^k, 32) features in the plan's dtype (of this rank's rows
    of ``axis``)."""
    x = img.to(plan.head.w.dtype).contiguous()
    for down, rb1, rb2 in plan.stages:
        x = conv_rows(x, down, axis)
        x = conv_rows(conv_rows(x, rb1, axis), rb2, axis, residual=x)
    return conv_rows(x, plan.head, axis)
