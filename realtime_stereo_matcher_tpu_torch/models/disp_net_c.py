"""MobileDispNetC, plain PyTorch (port of ``realtime_stereo_matcher_tpu/models/disp_net_c.py``;
reference model/mobile_disp_net_c.py:237-412).

A siamese conv1 / conv2 encoder to 1/4 resolution, a mean-correlation
volume of ``max_disp / 4`` levels there, a redirect conv, a residual encoder
down to 1/64, and five upsampling blocks, each predicting a disparity.  The
six predictions, coarse to fine, are bilinearly upsampled to full resolution
(scaled by the width ratio) and negated; their sign is not constrained.
Inputs pad to a multiple of 64 inside the model and every map is cropped
back.

Train mode updates the siamese BatchNorms twice a step, left then right,
as the reference (and the JAX package, which calls one Flax module twice)
does: here the same module is called twice.  Module attribute names are
the reference's, so ``state_dict()`` keys are the ones the JAX package's
importer reads (``torch_import._map_dispnetc``).  No TPU kernel ran on this
model in the JAX package, and no kernel of the port runs here.
"""

from __future__ import annotations

import torch
from torch import nn

from realtime_stereo_matcher_tpu_torch.models.layers import (
    LEAKY_SLOPE_DISPNET,
    BatchNorm2d,
    BN_EPS,
    BN_MOMENTUM,
    normalize_images,
)
from realtime_stereo_matcher_tpu_torch.ops import (
    correlation_cost_volume,
    pad_to_multiple,
    resize_bilinear,
    soft_argmin,
)

# the encoder's stride-2 stages: inputs pad to a multiple of 2 ** 6
DOWN_FACTOR = 6


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def disparity_regression(corr_volume: torch.Tensor, max_disp: int):
    """Softmax disparity regression over a (B, D, H, W) volume (reference
    model/mobile_disp_net_c.py:208-220, which, like the JAX package,
    defines it and does not use it in the forward): ``sum_d d *
    softmax(corr)[d]`` as (B, 1, H, W)."""
    if corr_volume.ndim != 4 or corr_volume.shape[1] != max_disp:
        raise ValueError(f"expected (B, {max_disp}, H, W), got "
                         f"{tuple(corr_volume.shape)}")
    return soft_argmin(corr_volume, axis=1, keepdims=True)


def disparity_interpolate(disp: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, h, w, 1) -> (B, H, W, 1): the disparity scaled by the width
    ratio, then bilinearly upsampled (reference :223-234)."""
    if tuple(disp.shape[1:3]) == tuple(out_hw):
        return disp
    return resize_bilinear(disp * (float(out_hw[1]) / disp.shape[2]), out_hw)


class Conv2dBlock(nn.Module):
    """Conv (no bias) + BatchNorm + LeakyReLU(0.1) in ``layer`` (reference
    :9-55); without the BatchNorm where ``with_batch_norm`` is off.  NCHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, with_batch_norm: bool = True):
        super().__init__()
        layers = [nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                            padding=(kernel - 1) // 2, bias=False)]
        if with_batch_norm:
            layers.append(_bn(out_ch))
        layers.append(nn.LeakyReLU(LEAKY_SLOPE_DISPNET))
        self.layer = nn.Sequential(*layers)

    def forward(self, x):
        return self.layer(x)


class ResBlockC(nn.Module):
    """conv-BN-ReLU-conv-BN plus a 1x1 + BN shortcut, then ReLU (reference
    :112-141); the convs carry biases.  NCHW."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1)
        self.bn1 = _bn(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.bn2 = _bn(out_ch)
        self.shortcut = (nn.Sequential(nn.Conv2d(in_ch, out_ch, 1,
                                                 stride=stride), _bn(out_ch))
                         if stride != 1 or in_ch != out_ch else None)

    def forward(self, x):
        residual = x if self.shortcut is None else self.shortcut(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + residual)


class _Deconv(nn.Module):
    """ConvTranspose2d(k 4, stride 2, padding 1) + BN + LeakyReLU(0.1) in
    ``layer``: an exact 2x upsample (Flax ``padding="SAME"`` with the taps
    flipped)."""

    def __init__(self, in_ch: int, out_ch: int, with_batch_norm: bool):
        super().__init__()
        layers = [nn.ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1,
                                     bias=False)]
        if with_batch_norm:
            layers.append(_bn(out_ch))
        layers.append(nn.LeakyReLU(LEAKY_SLOPE_DISPNET))
        self.layer = nn.Sequential(*layers)

    def forward(self, x):
        return self.layer(x)


class UpsampleBlock(nn.Module):
    """Deconv, skip concat and a disparity side-prediction (reference
    :144-185).  ``forward(bottom, skip)`` returns the disparity predicted
    from ``bottom`` and the merged features at twice its size.  NCHW."""

    def __init__(self, in_ch: int, out_ch: int, skip_ch: int,
                 with_batch_norm: bool = True):
        super().__init__()
        self.deconv = _Deconv(in_ch, out_ch, with_batch_norm)
        self.predict = nn.Conv2d(in_ch, 1, 3, padding=1, bias=False)
        self.up_predict = nn.ConvTranspose2d(1, 1, 4, stride=2, padding=1,
                                             bias=False)
        self.concat = nn.Conv2d(skip_ch + out_ch + 1, out_ch, 3, padding=1,
                                bias=False)

    def forward(self, bottom, skip):
        y = self.deconv(bottom)
        disp = self.predict(bottom)
        merged = torch.cat([skip, y, self.up_predict(disp)], dim=1)
        return disp, self.concat(merged)


class MobileDispNetC(nn.Module):
    """Reference model/mobile_disp_net_c.py:237-412.

    forward: (left, right) uint8-range NHWC -> [6 x (B, H, W, 1)] negative
    disparity, coarse to fine, in train and eval mode.  The reference's
    ``freeze`` and weight / bias parameter groups are in
    ``train/freeze.py``."""

    def __init__(self, hidden_dim: int = 32, max_disp: int = 192,
                 with_batch_norm: bool = True):
        super().__init__()
        hd, bn = hidden_dim, with_batch_norm
        self.hidden_dim = hidden_dim
        self.max_disp = max_disp
        self.conv1 = Conv2dBlock(3, hd, 7, 2, bn)
        self.conv2 = Conv2dBlock(hd, 2 * hd, 5, 2, bn)
        self.conv_redir = Conv2dBlock(2 * hd, hd, 1, 1, bn)
        self.conv3 = nn.Sequential(
            Conv2dBlock(hd + max_disp // 4, 4 * hd, 5, 2, bn),
            Conv2dBlock(4 * hd, 4 * hd, 3, 1, False))
        self.res4 = ResBlockC(4 * hd, 8 * hd, 2)
        self.res5 = ResBlockC(8 * hd, 16 * hd, 2)
        self.res6 = ResBlockC(16 * hd, 32 * hd, 2)
        self.up5 = UpsampleBlock(32 * hd, 16 * hd, 16 * hd, bn)
        self.up4 = UpsampleBlock(16 * hd, 8 * hd, 8 * hd, bn)
        self.up3 = UpsampleBlock(8 * hd, 4 * hd, 4 * hd, bn)
        self.up2 = UpsampleBlock(4 * hd, 2 * hd, 2 * hd, bn)
        self.up1 = UpsampleBlock(2 * hd, hd, hd, bn)
        self.predict = nn.Conv2d(hd, 1, 3, padding=1, bias=False)

    def forward(self, left_img, right_img):
        dtype = self.predict.weight.dtype
        align = 2 ** DOWN_FACTOR
        left, orig_hw = pad_to_multiple(normalize_images(left_img, dtype),
                                        align)
        right, _ = pad_to_multiple(normalize_images(right_img, dtype), align)
        out_hw = left.shape[1:3]

        l_conv1 = self.conv1(left.permute(0, 3, 1, 2))
        r_conv1 = self.conv1(right.permute(0, 3, 1, 2))
        l_conv2 = self.conv2(l_conv1)
        r_conv2 = self.conv2(r_conv1)

        l_redir = self.conv_redir(l_conv2)
        corr = correlation_cost_volume(l_conv2.permute(0, 2, 3, 1),
                                       r_conv2.permute(0, 2, 3, 1),
                                       self.max_disp // 4)
        x = torch.cat([l_redir, corr.to(l_redir.dtype)], dim=1)
        out_conv3 = self.conv3(x)
        out_res4 = self.res4(out_conv3)
        out_res5 = self.res5(out_res4)
        out_res6 = self.res6(out_res5)

        disp06, up5 = self.up5(out_res6, out_res5)
        disp05, up4 = self.up4(up5, out_res4)
        disp04, up3 = self.up3(up4, out_conv3)
        disp03, up2 = self.up2(up3, l_conv2)
        disp02, up1 = self.up1(up2, l_conv1)
        disp01 = self.predict(up1)
        return [-1.0 * disparity_interpolate(d.permute(0, 2, 3, 1), out_hw)[
                    :, :orig_hw[0], :orig_hw[1]]
                for d in (disp06, disp05, disp04, disp03, disp02, disp01)]
