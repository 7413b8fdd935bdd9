"""Building blocks of the models (port of ``realtime_stereo_matcher_tpu/models/layers.py``).

The modules are plain ``nn.Sequential`` stacks laid out as in the reference
torch model, so their state-dict keys are the reference's
(``<prefix>.0.weight`` for the conv, ``<prefix>.1.*`` for its BatchNorm).
They run NCHW / NCDHW internally, as torch convolutions do; the public
functions of the port take NHWC.

Padding: the JAX package's ``torch_pad(p)`` spells out the symmetric
padding that torch's ``padding=p`` gives, so the port passes ``padding=p``.
Flax ``padding="SAME"`` on v3's 4x4 stride-2 convs is TensorFlow's SAME,
which pads one more row and column at the far end of an odd size than at
the near end; torch's ``padding=1`` does not, so :class:`SameConv2d` pads
explicitly (:func:`tf_same_pad_k4s2`).
BatchNorm uses the torch defaults the JAX package pins: eps 1e-5 and
momentum 0.1 (flax momentum 0.9).  In train mode it follows flax, not torch
(:class:`BatchNorm2d`): the running variance takes the biased batch
variance.  :class:`GroupedBatchNorm2d` normalizes two views stacked on the
batch axis each by its own statistics (V4's siamese extractor).  Under
:func:`synced_bn` (the data-parallel plain step) their train-mode
statistics are the global batch's, summed over the ranks (sync-BN).

MobileStereoNetV4's MobileNet blocks (:class:`MobileV2Residual`,
:class:`ConvBNDws`, :class:`MobileV1Residual`) and the transposed conv of
its hourglass (:class:`ConvTransposeBN`) keep the reference's Sequential
indices, so their state-dict keys are the ones the JAX package's importer
reads (``torch_import._map_v4``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from realtime_stereo_matcher_tpu_torch import stats_dtype
from realtime_stereo_matcher_tpu_torch.parallel.distributed import all_reduce_sum

BN_MOMENTUM = 0.1
BN_EPS = 1e-5
LEAKY_SLOPE = 0.2  # the v3 U-Net's leaky ReLU (JAX layers.leaky_relu_02)
LEAKY_SLOPE_DISPNET = 0.1  # MobileDispNetC's (JAX layers.leaky_relu_01)


def leaky_relu_02(x: torch.Tensor) -> torch.Tensor:
    """Leaky ReLU with negative slope 0.2 (v3 U-Net activation)."""
    return F.leaky_relu(x, LEAKY_SLOPE)


def leaky_relu_01(x: torch.Tensor) -> torch.Tensor:
    """Leaky ReLU with negative slope 0.1 (MobileDispNetC activation)."""
    return F.leaky_relu(x, LEAKY_SLOPE_DISPNET)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(max(x, 0), 6) (the MobileNet blocks' activation)."""
    return F.relu6(x)


def tf_same_pad_k4s2(n: int) -> tuple[int, int]:
    """TF-SAME (low, high) padding of a 4-wide, stride-2 conv along an axis
    of size ``n``: 1 before, and 1 after an even size or 2 after an odd
    one, so the output has ceil(n / 2) positions."""
    return 1, 1 + n % 2


class SameConv2d(nn.Conv2d):
    """4x4 stride-2 conv with TF-SAME zero padding (reference ``SameConv2d``,
    model/mobile_stereo_net_v3.py:146-167; flax ``padding="SAME"``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 4, stride=2, padding=0, bias=True)

    def forward(self, x):  # NCHW
        (top, bottom), (left, right) = (tf_same_pad_k4s2(n)
                                        for n in x.shape[-2:])
        return super().forward(F.pad(x, (left, right, top, bottom)))


def batch_stats(y: torch.Tensor, dims, group=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """flax train-mode statistics: mean and biased variance ``E[y^2] -
    E[y]^2`` over ``dims``, in float32 (float64 for float64 ``y``), as
    ``mu = s / count`` and ``var = s2 / count - mu^2`` from the sums ``s``,
    ``s2`` and the count.

    The three go through one differentiable all-reduce over ``group`` (a
    ``torch.distributed`` group; None: one process, no collective), so with
    a group the statistics are the global batch's (sync-BN), the JAX
    package's ``psum`` of its BatchNorm sums, and a group of one rank gives
    the one-process numbers bit for bit."""
    yf = y.to(stats_dtype(y.dtype))
    s, s2 = yf.sum(dims), (yf * yf).sum(dims)
    count = yf.new_full((1,), yf.numel() // max(s.numel(), 1))
    packed = all_reduce_sum(torch.cat([s.reshape(-1), s2.reshape(-1), count]),
                            group, what="batch-norm sums")
    n = s.numel()
    mu = packed[:n].view_as(s) / packed[2 * n]
    return mu, packed[n:2 * n].view_as(s) / packed[2 * n] - mu * mu


def running_update(old: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """flax running-stat update with momentum 0.9 (torch 0.1)."""
    m = 1.0 - BN_MOMENTUM
    return m * old + (1.0 - m) * batch.detach()


class _FlaxBatchNorm:
    """Train mode with flax semantics on a torch BatchNorm (state-dict keys
    unchanged): float32 (float64 for float64 inputs) batch statistics over
    N and the spatial axes, the
    output ``(y - mean) * (weight / sqrt(var + eps)) + bias`` cast back to
    y's dtype, and running stats updated with the *biased* variance.  torch
    updates them with the unbiased one, a factor n/(n-1) on the update term
    that the JAX package (the reference) does not have.  Eval mode is
    torch's."""

    sync_group = None  # set by synced_bn: statistics over all ranks

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = (0, *range(2, x.ndim))
        mu, var = batch_stats(x, dims, self.sync_group)
        var = var.clamp(min=0.0)  # flax clips round-off below zero
        with torch.no_grad():
            self.running_mean.copy_(running_update(self.running_mean, mu))
            self.running_var.copy_(running_update(self.running_var, var))
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.to(mu.dtype) - mu.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode follows flax (see _FlaxBatchNorm)."""


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` whose train mode follows flax (see _FlaxBatchNorm)."""


class GroupedBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over ``groups`` sub-batches stacked along the batch axis
    (JAX ``GroupedBatchNorm``, models/layers.py:35-116).

    In train mode each group of N / ``groups`` consecutive images is
    normalized by its own float32 statistics (float64 for float64 inputs;
    biased variance ``E[x^2] - mu^2``), and the running stats take the
    groups' updates one after the other, in closed form ``m^G r + sum_g
    m^(G-1-g) (1 - m) batch_g`` with ``m`` = 0.9: one batched pass equals G
    sequential passes of one BatchNorm, which is how the reference runs its
    siamese extractor on the left view, then the right.  Under
    :func:`synced_bn` each group's statistics are taken over that group of
    every rank (the ranks' left views, then their right views).  The output
    is ``x * s + b`` with ``s = weight / sqrt(var + eps)`` and ``b = bias -
    mu * s`` cast to x's dtype, the JAX package's folded form.  Eval mode is
    torch's running-stats affine, for any batch.  The variance is clipped at
    0, as in flax's BatchNorm.  A ``_BatchNorm``, so ``train/freeze.py``
    freezes it."""

    sync_group = None  # set by synced_bn: statistics over all ranks

    def __init__(self, num_features: int, groups: int = 2, **kw):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM, **kw)
        self.groups = groups

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        g, c = self.groups, x.shape[1]
        if x.shape[0] % g:
            raise ValueError(f"batch {x.shape[0]} is not {g} equal groups")
        xg = x.reshape(g, -1, *x.shape[1:])             # (G, b, C, H, W)
        dims = (1, *range(3, xg.ndim))
        mu, var = batch_stats(xg, dims, self.sync_group)  # (G, C)
        # clipped at 0 as flax's BatchNorm clips it (the JAX package's
        # GroupedBatchNorm does not: a round-off below -eps gives NaN)
        var = var.clamp(min=0.0)
        with torch.no_grad():
            m = 1.0 - BN_MOMENTUM
            w = m ** torch.arange(g - 1, -1, -1, dtype=mu.dtype,
                                  device=x.device)
            for run, batch in ((self.running_mean, mu),
                               (self.running_var, var)):
                run.copy_(m ** g * run
                          + (1.0 - m) * (w[:, None] * batch.detach()).sum(0))
            self.num_batches_tracked.add_(g)
        s = self.weight[None] * torch.rsqrt(var + self.eps)  # (G, C)
        b = self.bias[None] - mu * s
        shape = (g, 1, c) + (1,) * (x.ndim - 2)
        y = xg * s.view(shape).to(x.dtype) + b.view(shape).to(x.dtype)
        return y.reshape(x.shape)


@contextlib.contextmanager
def synced_bn(model: nn.Module, group):
    """Sync-BN for the block: every train-mode :class:`BatchNorm2d`,
    :class:`BatchNorm3d` and :class:`GroupedBatchNorm2d` of ``model`` takes
    its statistics over the global batch of ``group``'s ranks
    (:func:`batch_stats`), as the JAX package's Flax path does under
    jit-level batch sharding.  ``group=None`` changes nothing."""
    bns = [m for m in model.modules()
           if isinstance(m, (_FlaxBatchNorm, GroupedBatchNorm2d))]
    for m in bns:
        m.sync_group = group
    try:
        yield model
    finally:
        for m in bns:
            del m.sync_group


def batch_norm2d(channels: int, groups: int = 1) -> nn.Module:
    """:class:`BatchNorm2d`, or :class:`GroupedBatchNorm2d` over ``groups``
    stacked sub-batches (JAX ``ConvBN(bn_groups=...)``)."""
    if groups > 1:
        return GroupedBatchNorm2d(channels, groups)
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


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


def conv_bn(in_ch: int, out_ch: int, kernel: int = 1, *, stride: int = 1,
            padding: int = 0, dilation: int = 1, groups: int = 1,
            bn_groups: int = 1) -> nn.Sequential:
    """Sequential(Conv2d without bias, BatchNorm) -- the reference's
    ``convbn`` (keys ``.0`` and ``.1``)."""
    return nn.Sequential(
        nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                  dilation=dilation, groups=groups, bias=False),
        batch_norm2d(out_ch, bn_groups))


class MobileV2Residual(nn.Module):
    """MobileNetV2 inverted residual (JAX ``MobileV2Residual``,
    models/layers.py:218; reference mobile_stereo_net_v4.py:91-148): a 1x1
    expansion to ``in_ch * expanse_ratio`` + BN + ReLU6, a depthwise 3x3 +
    BN + ReLU6, a linear 1x1 + BN, and the skip where the stride is 1 and
    the widths agree.  ``conv`` holds the reference's Sequential (keys
    ``conv.0`` / ``.1`` / ``.3`` / ``.4`` / ``.6`` / ``.7``), V4's
    expansion ratios being 2 and 3.  NCHW."""

    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 expanse_ratio: int, dilation: int = 1, bn_groups: int = 1):
        super().__init__()
        hidden = int(in_ch * expanse_ratio)
        self.use_res = stride == 1 and in_ch == out_ch
        self.conv = nn.Sequential(
            *conv_bn(in_ch, hidden, bn_groups=bn_groups), nn.ReLU6(),
            *conv_bn(hidden, hidden, 3, stride=stride, padding=dilation,
                     dilation=dilation, groups=hidden, bn_groups=bn_groups),
            nn.ReLU6(),
            *conv_bn(hidden, out_ch, bn_groups=bn_groups))

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res else y


class ConvBNDws(nn.Sequential):
    """Depthwise-separable conv (JAX ``ConvBNDws``, models/layers.py:257;
    reference ``convbn_dws``): a depthwise 3x3 + BN + ReLU6, then a 1x1 +
    BN (+ ReLU6 where ``second_relu``).  Keys ``.0`` / ``.1`` / ``.3`` /
    ``.4``.  NCHW."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, pad: int,
                 dilation: int, second_relu: bool = True, bn_groups: int = 1):
        p = dilation if dilation > 1 else pad
        layers = [*conv_bn(in_ch, in_ch, 3, stride=stride, padding=p,
                           dilation=dilation, groups=in_ch,
                           bn_groups=bn_groups),
                  nn.ReLU6(),
                  *conv_bn(in_ch, out_ch, bn_groups=bn_groups)]
        if second_relu:
            layers.append(nn.ReLU6())
        super().__init__(*layers)


class MobileV1Residual(nn.Module):
    """MobileNetV1 residual (JAX ``MobileV1Residual``, models/layers.py:290;
    reference mobile_stereo_net_v4.py:68-88): two :class:`ConvBNDws`, the
    second without its last ReLU6, plus the input, through a strided 1x1 +
    BN (``downsample``) where ``downsample`` is set.  NCHW."""

    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 downsample: bool, pad: int, dilation: int,
                 bn_groups: int = 1):
        super().__init__()
        self.conv1 = ConvBNDws(in_ch, out_ch, stride, pad, dilation,
                               bn_groups=bn_groups)
        self.conv2 = ConvBNDws(out_ch, out_ch, 1, pad, dilation,
                               second_relu=False, bn_groups=bn_groups)
        self.downsample = (conv_bn(in_ch, out_ch, stride=stride,
                                   bn_groups=bn_groups)
                           if downsample else None)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + (x if self.downsample is None else self.downsample(x))


class ConvTransposeBN(nn.Sequential):
    """Sequential(ConvTranspose2d without bias, BatchNorm) (JAX
    ``ConvTransposeBN``, models/layers.py:318) as V4's hourglass has it:
    k 3, stride 2, padding 1, output_padding 1, an exact 2x upsample -- the
    Flax kernel's explicit ((1, 2), (1, 2)) padding, since torch puts the
    output padding on the high side.  Keys ``.0`` and ``.1``.  NCHW."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(
            nn.ConvTranspose2d(in_ch, out_ch, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            batch_norm2d(out_ch))


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
        # weight[0] spans the fan-in: (C_in / groups, k...) of a conv, and
        # (C_out / groups, k...) of a transposed conv, as torch counts it
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
