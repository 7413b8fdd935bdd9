"""Fused 3x3x3 convolution and the kernel-path cost filter (port of the TPU
kernel K3 of ``realtime_stereo_matcher_tpu/kernels/cost_filter3d.py``).

``fused_conv3d`` computes, on (B, D, H, W, C) volumes with SAME zero
padding in D, H and W,

    y = relu?(conv3x3x3(x, w) * scale + bias), cast to x's dtype.

On a CUDA tensor it launches the hand-written kernel of ``csrc/conv3d.cu``
(counted as ``fused_conv3d``); on a CPU tensor it runs
:func:`fused_conv3d_plain`.  There is no fallback from the one to the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from realtime_stereo_matcher_tpu_torch.kernels import _build
from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    ConvSpec,
    conv_spec,
)

SUPPORTED_CHANNELS = {(32, 32), (32, 1)}
KERNEL_NAME = "fused_conv3d"


def fused_conv3d_plain(x, w, scale, bias, *, relu=True):
    """Plain PyTorch version: float32 ``F.conv3d`` and the same epilogue.

    x (B, D, H, W, C_in), w (3, 3, 3, C_in, C_out) DHWIO, scale/bias
    (C_out,) f32.  Returns (B, D, H, W, C_out) in x's dtype."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3),
                 w.float().permute(4, 3, 0, 1, 2), padding=1)
    y = y.permute(0, 2, 3, 4, 1) * scale.float() + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()


def fused_conv3d(x, w, scale, bias, *, relu=True):
    """Fused 3x3x3 conv + scale/bias + optional ReLU on (B, D, H, W, C).

    Arguments as in :func:`fused_conv3d_plain`.  On CUDA: x and w share one
    dtype (float32 or bfloat16), scale and bias are float32, all are
    contiguous, and (C_in, C_out) is one of ``SUPPORTED_CHANNELS``."""
    if x.device.type == "cpu":
        return fused_conv3d_plain(x, w, scale, bias, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3d: unsupported device {x.device}")
    if x.ndim != 5 or w.ndim != 5:
        raise ValueError("fused_conv3d: x must be (B, D, H, W, C) and w DHWIO")
    b, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    if (cin, cout) not in SUPPORTED_CHANNELS:
        raise ValueError(f"fused_conv3d: {cin} -> {cout} channels not "
                         f"instantiated; have {sorted(SUPPORTED_CHANNELS)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_conv3d: dtype {x.dtype} not supported")
    if b * d > 65535:
        raise ValueError("fused_conv3d: B * D exceeds the grid limit")
    dev = x.device
    _build.require(x, "x", shape=x.shape, dtype=x.dtype, device=dev)
    _build.require(w, "w", shape=(3, 3, 3, cin, cout), dtype=x.dtype,
                   device=dev)
    for name, t in (("scale", scale), ("bias", bias)):
        _build.require(t, name, shape=(cout,), dtype=torch.float32, device=dev)

    out = torch.empty((b, d, h, wd, cout), dtype=x.dtype, device=dev)
    rc = _build.library().rsm_conv3d(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[x.dtype], b, d, h, wd, cin, cout,
        1 if relu else 0, dev.index, _build.stream_of(x))
    _build.check(rc, KERNEL_NAME)
    _build.LAUNCHES[KERNEL_NAME] += 1
    return out


def build_cost_filter_plan(cost_filter, *, dtype=torch.bfloat16
                           ) -> list[ConvSpec]:
    """Fold a port ``CostFilter3D`` (flat Sequential: conv, BN, ReLU at 3j,
    3j+1, 3j+2 for j < 4, then a conv with bias at 12) into five specs."""
    specs = [conv_spec(cost_filter[3 * j], cost_filter[3 * j + 1],
                       dtype=dtype, act="relu") for j in range(4)]
    specs.append(conv_spec(cost_filter[12], None, dtype=dtype, act="none"))
    return specs


def fast_cost_filter(vol: torch.Tensor, specs) -> torch.Tensor:
    """(B, D, h, w, C) difference volume -> (B, D, h, w) float32 filtered
    cost: the kernel-path ``CostFilter3D``.  The volume is cast to the specs'
    dtype."""
    x = vol.to(specs[0].w.dtype).contiguous()
    for spec in specs:
        x = fused_conv3d(x, spec.w, spec.scale, spec.bias,
                         relu=spec.act == "relu")
    return x[..., 0].float()
