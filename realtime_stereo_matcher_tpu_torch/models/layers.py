"""Building blocks of the v1 model (port of ``realtime_stereo_matcher_tpu/models/layers.py``).

The modules are plain ``nn.Sequential`` stacks laid out as in the reference
torch model, so their state-dict keys are the reference's
(``<prefix>.0.weight`` for the conv, ``<prefix>.1.*`` for its BatchNorm).
They run NCHW / NCDHW internally, as torch convolutions do; the public
functions of the port take NHWC.

Padding: the JAX package's ``torch_pad(p)`` spells out the symmetric
padding that torch's ``padding=p`` gives, so the port passes ``padding=p``.
BatchNorm uses the torch defaults the JAX package pins: eps 1e-5 and
momentum 0.1 (flax momentum 0.9).  In train mode it follows flax, not torch
(:class:`BatchNorm2d`): the running variance takes the biased batch
variance.
"""

from __future__ import annotations

import math

import torch
from torch import nn

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def batch_stats(y: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """flax train-mode statistics: float32 mean and biased variance
    ``E[y^2] - E[y]^2`` over ``dims``."""
    yf = y.float()
    mu = yf.mean(dims)
    return mu, (yf * yf).mean(dims) - mu * mu


def running_update(old: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """flax running-stat update with momentum 0.9 (torch 0.1)."""
    m = 1.0 - BN_MOMENTUM
    return m * old + (1.0 - m) * batch.detach()


class _FlaxBatchNorm:
    """Train mode with flax semantics on a torch BatchNorm (state-dict keys
    unchanged): float32 batch statistics over N and the spatial axes, the
    output ``(y - mean) * (weight / sqrt(var + eps)) + bias`` cast back to
    y's dtype, and running stats updated with the *biased* variance.  torch
    updates them with the unbiased one, a factor n/(n-1) on the update term
    that the JAX package (the reference) does not have.  Eval mode is
    torch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = (0, *range(2, x.ndim))
        mu, var = batch_stats(x, dims)
        var = var.clamp(min=0.0)  # flax clips round-off below zero
        with torch.no_grad():
            self.running_mean.copy_(running_update(self.running_mean, mu))
            self.running_var.copy_(running_update(self.running_var, var))
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mu.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode follows flax (see _FlaxBatchNorm)."""


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` whose train mode follows flax (see _FlaxBatchNorm)."""


def conv_bn_layers(in_ch: int, out_ch: int, *, stride: int = 1,
                   dilation: int = 1, ndim: int = 2) -> list[nn.Module]:
    """[3-wide Conv (no bias), BatchNorm, ReLU] with torch ``padding=dilation``."""
    conv = nn.Conv2d if ndim == 2 else nn.Conv3d
    bn = BatchNorm2d if ndim == 2 else BatchNorm3d
    return [conv(in_ch, out_ch, 3, stride=stride, padding=dilation,
                 dilation=dilation, bias=False),
            bn(out_ch, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.ReLU()]


class ConvBN(nn.Sequential):
    """3x3 Conv2d + BatchNorm + ReLU (reference ``conv_3x3`` / ``convbn``,
    model/mobile_stereo_net.py:30-43)."""

    def __init__(self, in_ch: int, out_ch: int, *, stride: int = 1,
                 dilation: int = 1):
        super().__init__(*conv_bn_layers(in_ch, out_ch, stride=stride,
                                         dilation=dilation))


def conv3x3(in_ch: int, out_ch: int, stride: int = 1,
            dilation: int = 1) -> ConvBN:
    """Reference ``conv_3x3``: Conv2d(3, s, padding=d, dilation=d) + BN + ReLU."""
    return ConvBN(in_ch, out_ch, stride=stride, dilation=dilation)


class ResBlock(nn.Module):
    """Two conv3x3(+BN+ReLU) with an additive skip after the second ReLU
    (reference model/mobile_stereo_net.py:46-56)."""

    def __init__(self, channels: int, dilation: int = 1):
        super().__init__()
        self.conv = nn.Sequential(conv3x3(channels, channels, dilation=dilation),
                                  conv3x3(channels, channels, dilation=dilation))

    def forward(self, x):
        return self.conv(x) + x


def normalize_images(img: torch.Tensor, dtype=None) -> torch.Tensor:
    """[0, 255] -> [-1, 1] (reference model/*.py forward preamble)."""
    x = img.to(dtype or torch.float32)
    return 2.0 * (x / 255.0) - 1.0


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Torch's default conv init (kaiming-uniform, a=sqrt(5): U(+-1/sqrt(fan_in))
    for weight and bias) drawn from ``generator`` instead of the global RNG.
    BatchNorm keeps its deterministic defaults.  ``generator`` must live on
    the parameters' device."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
