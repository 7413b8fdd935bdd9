"""MobileStereoNet v1, v2 and v3, plain PyTorch (port of ``realtime_stereo_matcher_tpu/models/stereo_net.py``).

* v1 (reference model/mobile_stereo_net.py:90-158): a fixed 32-dim encoder
  at 1/8 resolution, a 24-level difference cost volume, a 5-layer 3D-conv
  filter, soft-argmin, and 3 cascaded RGB-guided 2x refinements.
* v2 (reference model/mobile_stereo_net_v2.py:137-232): v1 whose
  refinements also see the right RGB warped by the current disparity.
* v3 (reference model/mobile_stereo_net_v3.py:249-336): a U-Net feature
  pyramid instead of the encoder; refinement i sees pyramid level i + 1 of
  the left view and of the right view warped by the current disparity.

Each returns a coarse-to-fine list of full-resolution **negative** disparity
maps (B, H, W, 1).

This is the plain path: torch convolutions throughout.  It runs on the CPU
and is the reference that the kernel path (``models/fast_infer.py``) is held
against on the card.  Module attribute names follow the reference torch
model, so ``state_dict()`` keys are the reference's (``feature_extractor.*``,
``cost_filter.*``, ``refine_layer.{r}.conv0.*`` for v1 and v2 and
``refine_layers.{r}.conv0.*`` for v3).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from realtime_stereo_matcher_tpu_torch.models.layers import (
    LEAKY_SLOPE,
    ResBlock,
    SameConv2d,
    conv3x3,
    conv_bn_layers,
    normalize_images,
)
from realtime_stereo_matcher_tpu_torch.ops import (
    difference_cost_volume,
    pad_to_multiple,
    resize_bilinear,
    resize_nearest,
    soft_argmin,
    warp_by_flow_map,
    warp_by_flow_map_banded,
)


class CostFilter3D(nn.Sequential):
    """Five 3x3x3 Conv3d layers collapsing C -> 1: four conv+BN+ReLU, then a
    conv with bias (reference model/mobile_stereo_net.py:103-117).

    ``forward`` takes the (B, D, H, W, C) volume and returns (B, D, H, W)."""

    def __init__(self, hidden_dim: int = 32):
        layers = []
        for _ in range(4):
            layers += conv_bn_layers(hidden_dim, hidden_dim, ndim=3)
        layers.append(nn.Conv3d(hidden_dim, 1, 3, padding=1, bias=True))
        super().__init__(*layers)

    def forward(self, vol):
        x = vol.permute(0, 4, 1, 2, 3)
        for layer in self:
            x = layer(x)
        return x[:, 0]


class FeatureEncoder(nn.Sequential):
    """Strided conv encoder: ``down_factor`` (stride-2 conv3x3, ResBlock)
    stages and a final conv with bias (reference
    model/mobile_stereo_net.py:97-101).  NHWC in, NHWC out."""

    def __init__(self, in_ch: int = 3, hidden_dim: int = 32,
                 down_factor: int = 3):
        layers = []
        c = in_ch
        for _ in range(down_factor):
            layers += [conv3x3(c, hidden_dim, stride=2), ResBlock(hidden_dim)]
            c = hidden_dim
        layers.append(nn.Conv2d(hidden_dim, hidden_dim, 3, padding=1,
                                bias=True))
        super().__init__(*layers)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for layer in self:
            x = layer(x)
        return x.permute(0, 2, 3, 1)


class RefineNet(nn.Module):
    """Dilated-ResBlock refinement (reference model/mobile_stereo_net.py:59-87,
    _v3.py:100-143): upsample disp 2x, concat the guidance, predict a
    residual, ReLU.

    ``warp_guidance=True`` (v2, v3) warps the right guidance by the upsampled
    disparity before the concat; the entry conv then sees ``disp ‖ l_guide ‖
    warped r_guide`` (``in_ch`` = 1 + 3 + 3 = 7 in v2, whose guides are the
    RGB images, and 1 + 2 x 32 = 65 in v3)."""

    def __init__(self, in_ch: int = 4, hidden_dim: int = 32,
                 dilations: Sequence[int] = (1, 2, 4, 8, 1, 1),
                 warp_guidance: bool = False):
        super().__init__()
        self.warp_guidance = warp_guidance
        self.conv0 = nn.Sequential(
            conv3x3(in_ch, hidden_dim),
            *[ResBlock(hidden_dim, d) for d in dilations],
            nn.Conv2d(hidden_dim, 1, 3, padding=1, bias=True))

    def forward(self, disp, l_guide, r_guide=None, max_shift=None):
        """(B, h, w, 1) disparity, (B, H, W, C) guides -> (B, 2h, 2w, 1).

        ``max_shift`` None warps at any disparity, as the Flax model does; a
        number warps with the banded contract of the kernel path
        (``ops.warp_by_flow_map_banded``), so the two can be compared."""
        h2, w2 = disp.shape[1] * 2, disp.shape[2] * 2
        disp = resize_bilinear(disp, (h2, w2)) * 2.0
        if l_guide.shape[1:3] != (h2, w2):
            l_guide = resize_bilinear(l_guide, (h2, w2))
        feats = [disp, l_guide]
        if r_guide is not None:
            if r_guide.shape[1:3] != (h2, w2):
                r_guide = resize_bilinear(r_guide, (h2, w2))
            if self.warp_guidance:
                r_guide = (warp_by_flow_map(r_guide, disp) if max_shift is None
                           else warp_by_flow_map_banded(r_guide, disp,
                                                        max_shift))
            feats.append(r_guide)
        x = torch.cat(feats, dim=-1).permute(0, 3, 1, 2)
        x = self.conv0(x).permute(0, 2, 3, 1)
        return torch.relu(disp + x)


def _leaky() -> nn.Module:
    return nn.LeakyReLU(LEAKY_SLOPE)


def _conv3x3_leaky(in_ch: int, out_ch: int) -> list[nn.Module]:
    return [nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=True), _leaky()]


class UpsampleBlock(nn.Module):
    """One up level of the U-Net (reference mobile_stereo_net_v3.py:170-190):
    ConvTranspose 2x2 stride 2 + leaky, concat with the skip, a 1x1 mix and
    two 3x3 convs, each + leaky.  NCHW."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.up_conv = nn.Sequential(
            nn.ConvTranspose2d(in_ch, out_ch, 2, stride=2, bias=True),
            _leaky())
        self.merge_conv = nn.Sequential(
            nn.Conv2d(2 * out_ch, out_ch, 1, bias=True), _leaky(),
            *_conv3x3_leaky(out_ch, out_ch), *_conv3x3_leaky(out_ch, out_ch))

    def forward(self, x, skip):
        return self.merge_conv(torch.cat([self.up_conv(x), skip], dim=1))


class UNetFeatureExtractor(nn.Module):
    """U-Net pyramid encoder (reference mobile_stereo_net_v3.py:193-246):
    a 3 -> C stem, then per level a 4x4 stride-2 TF-SAME conv and one 3x3
    conv (three at the last level), then up levels back to full resolution.
    Every conv has a bias and a leaky ReLU 0.2; there is no BatchNorm.

    NHWC in; returns the up-path pyramid coarse -> fine,
    [1/2^k, ..., 1/2, 1/1] x C, NHWC."""

    def __init__(self, hidden_dims: Sequence[int]):
        super().__init__()
        dims = tuple(hidden_dims)
        down = len(dims) - 1
        layers = [nn.Sequential(*_conv3x3_leaky(3, dims[0]))]
        for i in range(1, down + 1):
            convs = []
            for _ in range(3 if i == down else 1):
                convs += _conv3x3_leaky(dims[i], dims[i])
            layers.append(nn.Sequential(SameConv2d(dims[i - 1], dims[i]),
                                        _leaky(), *convs))
        self.down_layers = nn.ModuleList(layers)
        self.up_layers = nn.ModuleList(
            [UpsampleBlock(dims[down - j], dims[down - j - 1])
             for j in range(down)])

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        down = []
        for layer in self.down_layers:
            x = layer(x)
            down.append(x)
        up = [down[-1]]
        for j, block in enumerate(self.up_layers):
            up.append(block(up[-1], down[-2 - j]))
        return [y.permute(0, 2, 3, 1) for y in up]


def _coarse_disparity(l_feat, r_feat, max_disp, cost_filter):
    """Difference volume -> 3D filter -> soft-argmin -> (B, h, w, 1).

    ``cost_filter`` maps the (B, D, h, w, C) volume to (B, D, h, w).  The
    softmax weighs the filtered cost directly (higher = more weight), as the
    reference does (model/mobile_stereo_net.py:144-147)."""
    vol = difference_cost_volume(l_feat, r_feat, max_disp)
    cost = cost_filter(vol)
    return soft_argmin(cost, axis=1)[..., None]


def refine_max_shifts(max_disp: int, down_factor: int) -> list[int]:
    """The banded warp's bound at each refine level of the kernel path:
    the level's share of ``max_disp`` plus 16 px (JAX models/fast_infer.py,
    ``(max_disp >> (down - 1 - i)) + 16``)."""
    return [(max_disp >> (down_factor - 1 - i)) + 16
            for i in range(down_factor)]


def _full_res_nearest(disp, out_hw, orig_hw):
    """Reference full-res upsample: nearest interp of (disp * scale), cropped
    to the pre-pad size (model/mobile_stereo_net.py:154-156)."""
    scale = out_hw[1] / disp.shape[2]
    up = resize_nearest(disp * scale, out_hw)
    return up[:, : orig_hw[0], : orig_hw[1], :]


class MobileStereoNet(nn.Module):
    """v1 -- reference model/mobile_stereo_net.py:90-158.

    forward: (left, right) uint8-range NHWC -> [3 x (B, H, W, 1)] negative
    disparity, coarse to fine.  Eval mode only is ported; call ``.eval()``.
    """

    def __init__(self, down_factor: int = 3, max_disp: int = 192,
                 hidden_dim: int = 32,
                 refine_dilates: Sequence[int] = (1, 2, 4, 8, 1, 1)):
        super().__init__()
        self.down_factor = down_factor
        self.max_disp = max_disp
        self.hidden_dim = hidden_dim
        self.refine_dilates = tuple(refine_dilates)
        self.feature_extractor = FeatureEncoder(3, hidden_dim, down_factor)
        self.cost_filter = CostFilter3D(hidden_dim)
        self.refine_layer = nn.ModuleList(
            [RefineNet(4, hidden_dim, self.refine_dilates)
             for _ in range(down_factor)])

    def forward(self, left_img, right_img):
        align = 2 ** self.down_factor
        vol_disp = (self.max_disp + 1) // align
        dtype = self.cost_filter[0].weight.dtype

        left, orig_hw = pad_to_multiple(normalize_images(left_img, dtype), align)
        right, _ = pad_to_multiple(normalize_images(right_img, dtype), align)

        lf = self.feature_extractor(left)
        rf = self.feature_extractor(right)
        x = _coarse_disparity(lf, rf, vol_disp, self.cost_filter)

        multi_scale = []
        out_hw = left.shape[1:3]
        for refine in self.refine_layer:
            x = refine(x, left)
            multi_scale.append(_full_res_nearest(x, out_hw, orig_hw))
        return [-1.0 * m for m in multi_scale]


class MobileStereoNetV2(nn.Module):
    """v2 -- reference model/mobile_stereo_net_v2.py:137-232: v1 whose
    refinement i also sees the right RGB warped by the current disparity
    (``refine_dim`` = 1 disparity + 3 left RGB + 3 warped right RGB input
    channels).

    forward: (left, right) uint8-range NHWC -> [3 x (B, H, W, 1)] negative
    disparity, coarse to fine.  ``banded_warp=True`` warps with the kernel
    path's band (:func:`refine_max_shifts`) instead of at any disparity."""

    def __init__(self, down_factor: int = 3, max_disp: int = 192,
                 refine_dim: int = 7,
                 refine_dilates: Sequence[int] = (1, 2, 4, 8, 1, 1),
                 hidden_dim: int = 32):
        super().__init__()
        self.down_factor = down_factor
        self.max_disp = max_disp
        self.refine_dim = refine_dim
        self.hidden_dim = hidden_dim
        self.refine_dilates = tuple(refine_dilates)
        self.feature_extractor = FeatureEncoder(3, hidden_dim, down_factor)
        self.cost_filter = CostFilter3D(hidden_dim)
        self.refine_layer = nn.ModuleList(
            [RefineNet(refine_dim, hidden_dim, self.refine_dilates,
                       warp_guidance=True) for _ in range(down_factor)])

    def forward(self, left_img, right_img, *, banded_warp: bool = False):
        align = 2 ** self.down_factor
        vol_disp = (self.max_disp + 1) // align
        dtype = self.cost_filter[0].weight.dtype

        left, orig_hw = pad_to_multiple(normalize_images(left_img, dtype), align)
        right, _ = pad_to_multiple(normalize_images(right_img, dtype), align)

        lf = self.feature_extractor(left)
        rf = self.feature_extractor(right)
        x = _coarse_disparity(lf, rf, vol_disp, self.cost_filter)

        shifts = (refine_max_shifts(self.max_disp, self.down_factor)
                  if banded_warp else [None] * self.down_factor)
        multi_scale = []
        out_hw = left.shape[1:3]
        for i, refine in enumerate(self.refine_layer):
            x = refine(x, left, right, max_shift=shifts[i])
            multi_scale.append(_full_res_nearest(x, out_hw, orig_hw))
        return [-1.0 * m for m in multi_scale]


class MobileStereoNetV3(nn.Module):
    """v3 -- reference model/mobile_stereo_net_v3.py:249-336: U-Net pyramid
    features; refinement i sees pyramid level i + 1 of both views, the right
    one warped by the current disparity.

    forward: (left, right) uint8-range NHWC -> [3 x (B, H, W, 1)] negative
    disparity, coarse to fine.  ``banded_warp=True`` warps with the kernel
    path's band (:func:`refine_max_shifts`) instead of at any disparity.
    Eval mode only is ported; call ``.eval()``."""

    def __init__(self, down_factor: int = 3, max_disp: int = 192,
                 refine_dilates: Sequence[int] = (1, 2, 4, 8, 1, 1),
                 hidden_dim: int = 32):
        super().__init__()
        self.down_factor = down_factor
        self.max_disp = max_disp
        self.hidden_dim = hidden_dim
        self.refine_dilates = tuple(refine_dilates)
        self.feature_extractor = UNetFeatureExtractor(
            (hidden_dim,) * (down_factor + 1))
        self.cost_filter = CostFilter3D(hidden_dim)
        self.refine_layers = nn.ModuleList(
            [RefineNet(1 + 2 * hidden_dim, hidden_dim, self.refine_dilates,
                       warp_guidance=True) for _ in range(down_factor)])

    def forward(self, left_img, right_img, *, banded_warp: bool = False):
        align = 2 ** self.down_factor
        vol_disp = (self.max_disp + 1) // align
        dtype = self.cost_filter[0].weight.dtype

        left, orig_hw = pad_to_multiple(normalize_images(left_img, dtype), align)
        right, _ = pad_to_multiple(normalize_images(right_img, dtype), align)

        l_py = self.feature_extractor(left)
        r_py = self.feature_extractor(right)
        x = _coarse_disparity(l_py[0], r_py[0], vol_disp, self.cost_filter)

        shifts = (refine_max_shifts(self.max_disp, self.down_factor)
                  if banded_warp else [None] * self.down_factor)
        multi_scale = []
        out_hw = left.shape[1:3]
        for i, refine in enumerate(self.refine_layers):
            x = refine(x, l_py[i + 1], r_py[i + 1], max_shift=shifts[i])
            multi_scale.append(_full_res_nearest(x, out_hw, orig_hw))
        return [-1.0 * m for m in multi_scale]
