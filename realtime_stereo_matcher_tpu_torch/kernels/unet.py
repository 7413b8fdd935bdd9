"""MobileStereoNetV3's U-Net pyramid on the fused conv kernels (port of
``realtime_stereo_matcher_tpu/kernels/unet.py``, ``build_unet_plan`` and
``fast_unet``).

The U-Net (``models.stereo_net.UNetFeatureExtractor``) is bias convs and
leaky ReLU 0.2, no BatchNorm, over a 32-channel pyramid.  Per view:

* K1 (``fused_conv3x3``): the 3 -> 32 stem, one 3x3 conv at 1/2 and at 1/4,
  three at 1/8, and two per up level -- 12 launches;
* K2-4x4 (``fused_conv4x4_s2``): the 4x4 stride-2 TF-SAME downsampler of
  each level -- 3 launches;
* plain PyTorch: the ConvTranspose 2x2 stride-2 up-projection and the 1x1
  skip mix (``F.conv_transpose2d`` / ``F.conv2d``), as the JAX package left
  them to XLA as block matmuls.

The TPU layout of the JAX package's flat plan (pixel phases, lane folds) is
not carried over: every level is a plain NHWC tensor.  Weights are folded
once, when the plan is built.  Given a row axis (``parallel/halo.py``), the
same forward runs on this rank's rows of every pyramid level, each conv on
its haloed tile.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    ConvSpec,
    conv_spec,
    plain_scale_bias,
)
from realtime_stereo_matcher_tpu_torch.models.layers import (
    LEAKY_SLOPE,
    leaky_relu_02,
)
from realtime_stereo_matcher_tpu_torch.parallel.halo import (
    ONE,
    conv4x4_rows,
    conv_rows,
    conv_transpose2d_rows,
)
from realtime_stereo_matcher_tpu_torch.parallel.mesh import Axis


@dataclasses.dataclass(frozen=True)
class UpLevel:
    """One up level: the ConvTranspose and 1x1 mix (OIHW-family torch
    weights, the path's dtype) and its two 3x3 kernel convs."""

    up_w: torch.Tensor
    up_b: torch.Tensor
    mix_w: torch.Tensor
    mix_b: torch.Tensor
    convs: tuple  # tuple[ConvSpec, ConvSpec]


@dataclasses.dataclass(frozen=True)
class UNetPlan:
    stem: ConvSpec
    down: tuple   # per level: (4x4 stride-2 ConvSpec, tuple[ConvSpec, ...])
    up: tuple     # per level, coarse to fine: UpLevel

    @property
    def dtype(self) -> torch.dtype:
        return self.stem.w.dtype


def _leaky_spec(conv, dtype) -> ConvSpec:
    return conv_spec(conv, None, dtype=dtype, act=LEAKY_SLOPE)


@torch.no_grad()
def _down4x4(conv, dtype) -> ConvSpec:
    """A ``SameConv2d`` as a leaky 4x4 stride-2 spec (HWIO weights)."""
    scale, bias = plain_scale_bias(conv.bias, conv.out_channels,
                                   conv.weight.device)
    w = conv.weight.detach().permute(2, 3, 1, 0).to(dtype).contiguous()
    return ConvSpec(w, scale, bias, LEAKY_SLOPE, stride=2)


@torch.no_grad()
def build_unet_plan(unet, *, dtype=torch.bfloat16) -> UNetPlan:
    """Fold a port ``UNetFeatureExtractor`` into a kernel plan.

    ``down_layers[0]`` is the stem (conv, leaky); ``down_layers[i]`` is
    (SameConv2d, leaky, then conv, leaky pairs); ``up_layers[j]`` has
    ``up_conv`` (ConvTranspose, leaky) and ``merge_conv`` (1x1, leaky, two
    (3x3, leaky))."""
    stem = _leaky_spec(unet.down_layers[0][0], dtype)
    down = []
    for level in list(unet.down_layers)[1:]:
        convs = tuple(_leaky_spec(level[k], dtype)
                      for k in range(2, len(level), 2))
        down.append((_down4x4(level[0], dtype), convs))
    up = []
    for block in unet.up_layers:
        ct, merge = block.up_conv[0], block.merge_conv
        up.append(UpLevel(*(t.detach().to(dtype) for t in (
                              ct.weight, ct.bias, merge[0].weight,
                              merge[0].bias)),
                          (_leaky_spec(merge[2], dtype),
                           _leaky_spec(merge[4], dtype))))
    return UNetPlan(stem, tuple(down), tuple(up))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def fast_unet(img: torch.Tensor, plan: UNetPlan,
              axis: Axis = ONE) -> list[torch.Tensor]:
    """Kernel-path ``UNetFeatureExtractor``: (B, H, W, 3) normalized image
    (H, W multiples of 8) -> the pyramid [1/8, 1/4, 1/2, full] in the
    plan's dtype, NHWC (of this rank's rows of ``axis``)."""
    x = conv_rows(img.to(plan.dtype).contiguous(), plan.stem, axis)
    down = [x]
    for k4, convs in plan.down:
        x = conv4x4_rows(x, k4, axis)
        for spec in convs:
            x = conv_rows(x, spec, axis)
        down.append(x)
    pyramid = [x]
    for j, lvl in enumerate(plan.up):
        y = leaky_relu_02(conv_transpose2d_rows(_nchw(x), lvl.up_w, lvl.up_b,
                                                axis, stride=(2, 2)))
        y = torch.cat([y, _nchw(down[-2 - j])], dim=1)
        y = leaky_relu_02(F.conv2d(y, lvl.mix_w, lvl.mix_b))
        x = y.permute(0, 2, 3, 1).contiguous()
        for spec in lvl.convs:
            x = conv_rows(x, spec, axis)
        pyramid.append(x)
    return pyramid
