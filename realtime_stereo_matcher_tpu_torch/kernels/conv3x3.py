"""Fused 3x3 convolution (port of the TPU kernels K1 and K2 of
``realtime_stereo_matcher_tpu/kernels/conv3x3.py``).

``fused_conv3x3`` computes, on NHWC tensors,

    y = act(conv3x3(x, w) * scale + bias), cast to x's dtype, then + residual

with stride 1 (SAME zero padding, dilation d) or stride 2 (torch padding 1,
halving H and W), in the epilogue order of the TPU kernel: the residual is
added after the activation and the cast.  ``act`` is ``"relu"``, ``"none"``
or a float, the negative slope of a leaky ReLU.

On a CUDA tensor it launches the hand-written kernel of ``csrc/conv3x3.cu``
(stride 1 counts as ``fused_conv3x3``, stride 2 as ``fused_conv3x3_s2``, the
two TPU kernels it replaces); on a CPU tensor it runs
:func:`fused_conv3x3_plain`.  There is no fallback from the one to the other.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from realtime_stereo_matcher_tpu_torch.kernels import _build

# (C_in, C_out) pairs csrc/conv3x3.cu instantiates, by stride
SUPPORTED_CHANNELS = {1: {(32, 32), (4, 32), (32, 1), (32, 4), (1, 32)},
                      2: {(32, 32), (3, 32)}}
KERNEL_NAMES = {1: "fused_conv3x3", 2: "fused_conv3x3_s2"}
_ACT_CODES = {"none": 0, "relu": 1}  # a float is leaky ReLU (code 2)


def output_hw(h: int, w: int, stride: int) -> tuple[int, int]:
    """Output size of a 3x3 conv with torch padding = dilation."""
    return ((h - 1) // stride + 1, (w - 1) // stride + 1)


def _activate(y: torch.Tensor, act) -> torch.Tensor:
    """The epilogue activation: ``"relu"``, ``"none"`` or a leaky slope."""
    if act == "relu":
        return torch.relu(y)
    if act == "none":
        return y
    if isinstance(act, float):
        return torch.clamp(y, min=0.0) + act * torch.clamp(y, max=0.0)
    raise ValueError(f"act must be 'relu', 'none' or a float, not {act!r}")


def fused_conv3x3_plain(x, w, scale, bias, *, stride=1, dilation=1,
                        act="relu", residual=None):
    """Plain PyTorch version: float32 ``F.conv2d`` and the same epilogue
    (float64 for float64 ``x``, so that gradients can be checked).

    x (N, H, W, C_in), w (3, 3, C_in, C_out) HWIO, scale/bias (C_out,) f32,
    residual (N, Ho, Wo, C_out) or None.  Returns (N, Ho, Wo, C_out) in
    x's dtype."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = F.conv2d(x.to(acc).permute(0, 3, 1, 2), w.to(acc).permute(3, 2, 0, 1),
                 stride=stride, padding=dilation, dilation=dilation)
    y = _activate(y.permute(0, 2, 3, 1) * scale.to(acc) + bias.to(acc), act)
    y = y.to(x.dtype)
    if residual is not None:
        y = y + residual
    return y.contiguous()


def fused_conv3x3(x, w, scale, bias, *, stride=1, dilation=1, act="relu",
                  residual=None):
    """Fused 3x3 conv + scale/bias + activation (+ residual), NHWC.

    Arguments as in :func:`fused_conv3x3_plain`.  On CUDA: x, w and residual
    share one dtype (float32 or bfloat16), scale and bias are float32, all
    are contiguous, and (C_in, C_out) is one of ``SUPPORTED_CHANNELS``."""
    if x.device.type == "cpu":
        return fused_conv3x3_plain(x, w, scale, bias, stride=stride,
                                   dilation=dilation, act=act,
                                   residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3x3: unsupported device {x.device}")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError("fused_conv3x3: x must be NHWC and w HWIO")
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    if stride not in SUPPORTED_CHANNELS:
        raise ValueError(f"fused_conv3x3: stride {stride} not supported")
    if (stride == 2 and dilation != 1) or dilation < 1:
        raise ValueError(f"fused_conv3x3: dilation {dilation} with stride {stride}")
    if (cin, cout) not in SUPPORTED_CHANNELS[stride]:
        raise ValueError(f"fused_conv3x3: {cin} -> {cout} channels at stride "
                         f"{stride} not instantiated; have "
                         f"{sorted(SUPPORTED_CHANNELS[stride])}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_conv3x3: dtype {x.dtype} not supported")
    if n > 65535:
        raise ValueError("fused_conv3x3: batch exceeds the grid limit")
    ho, wo = output_hw(h, wd, stride)
    dev = x.device
    _build.require(x, "x", shape=x.shape, dtype=x.dtype, device=dev)
    _build.require(w, "w", shape=(3, 3, cin, cout), dtype=x.dtype, device=dev)
    for name, t in (("scale", scale), ("bias", bias)):
        _build.require(t, name, shape=(cout,), dtype=torch.float32, device=dev)
    if residual is not None:
        _build.require(residual, "residual", shape=(n, ho, wo, cout),
                       dtype=x.dtype, device=dev)
    if isinstance(act, float):
        act_code, alpha = 2, act
    elif act in _ACT_CODES:
        act_code, alpha = _ACT_CODES[act], 0.0
    else:
        raise ValueError(f"act must be 'relu', 'none' or a float, not {act!r}")

    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=dev)
    name = KERNEL_NAMES[stride]
    rc = _build.library().rsm_conv3x3(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(),
        _build.DTYPE_CODES[x.dtype], n, h, wd, cin, cout, ho, wo, stride,
        dilation, act_code, alpha, dev.index, _build.stream_of(x))
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return out


def fold_bn_scale_bias(gamma, beta, mean, var, eps=1e-5):
    """BatchNorm (eval) -> per-channel float32 (scale, bias)."""
    scale = gamma.float() / torch.sqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def plain_scale_bias(bias_vec, c_out: int, device=None):
    """No-BN epilogue: identity scale and the conv bias (or zeros)."""
    scale = torch.ones(c_out, dtype=torch.float32, device=device)
    if bias_vec is None:
        return scale, torch.zeros_like(scale)
    return scale, bias_vec.detach().float().clone()


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One fused conv of a kernel stack, weights folded and laid out.

    ``w`` is HWIO (or DHWIO for the 3D conv) in the path's dtype; ``scale``
    and ``bias`` are float32.  ``res_from`` indexes the activation history of
    a stack (history[0] is the stack input, history[j] the output of conv
    j-1); that activation is added after the activation function."""

    w: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    act: str | float = "relu"
    stride: int = 1
    dilation: int = 1
    res_from: int | None = None


@torch.no_grad()
def conv_spec(conv: nn.Module, bn: nn.Module | None, *, dtype, act,
              res_from: int | None = None) -> ConvSpec:
    """Fold a torch conv (and its eval-mode BatchNorm) into a :class:`ConvSpec`."""
    k = conv.kernel_size
    if any(s != 3 for s in k) or any(p != d for p, d in zip(conv.padding,
                                                           conv.dilation)):
        raise ValueError(f"kernel path needs 3-wide SAME convs, got {conv}")
    w = conv.weight.permute(*range(2, conv.weight.ndim), 1, 0)
    if bn is not None:
        if conv.bias is not None:
            raise ValueError("a conv followed by BatchNorm must have no bias")
        scale, bias = fold_bn_scale_bias(bn.weight, bn.bias, bn.running_mean,
                                         bn.running_var, bn.eps)
    else:
        scale, bias = plain_scale_bias(conv.bias, conv.out_channels,
                                       conv.weight.device)
    return ConvSpec(w.to(dtype).contiguous(), scale.contiguous(),
                    bias.contiguous(), act, conv.stride[0], conv.dilation[0],
                    res_from)


def convbn_spec(seq: nn.Sequential, *, dtype, res_from=None) -> ConvSpec:
    """A torch ``ConvBN`` (Sequential(conv, BN, ReLU)) as a ReLU :class:`ConvSpec`."""
    return conv_spec(seq[0], seq[1], dtype=dtype, act="relu", res_from=res_from)


def run_conv(x, spec: ConvSpec, residual=None):
    """One :class:`ConvSpec` through :func:`fused_conv3x3`."""
    return fused_conv3x3(x, spec.w, spec.scale, spec.bias, stride=spec.stride,
                         dilation=spec.dilation, act=spec.act,
                         residual=residual)
