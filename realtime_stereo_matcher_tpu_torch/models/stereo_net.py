"""MobileStereoNet v1, plain PyTorch (port of ``realtime_stereo_matcher_tpu/models/stereo_net.py``).

v1 (reference model/mobile_stereo_net.py:90-158): a fixed 32-dim encoder at
1/8 resolution, a 24-level difference cost volume, a 5-layer 3D-conv filter,
soft-argmin, and 3 cascaded RGB-guided 2x refinements.  The model returns a
coarse-to-fine list of full-resolution **negative** disparity maps
(B, H, W, 1).

This is the plain path: torch convolutions throughout.  It runs on the CPU
and is the reference that the kernel path (``models/fast_infer.py``) is held
against on the card.  Module attribute names follow the reference torch
model, so ``state_dict()`` keys are the reference's (``feature_extractor.*``,
``cost_filter.*``, ``refine_layer.{r}.conv0.*``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from realtime_stereo_matcher_tpu_torch.models.layers import (
    ResBlock,
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
    """Dilated-ResBlock refinement, v1 form (reference
    model/mobile_stereo_net.py:59-87): upsample disp 2x, concat the left RGB
    guide, predict a residual, ReLU."""

    def __init__(self, in_ch: int = 4, hidden_dim: int = 32,
                 dilations: Sequence[int] = (1, 2, 4, 8, 1, 1)):
        super().__init__()
        self.conv0 = nn.Sequential(
            conv3x3(in_ch, hidden_dim),
            *[ResBlock(hidden_dim, d) for d in dilations],
            nn.Conv2d(hidden_dim, 1, 3, padding=1, bias=True))

    def forward(self, disp, l_guide):
        """(B, h, w, 1) disparity, (B, H, W, 3) guide -> (B, 2h, 2w, 1)."""
        h2, w2 = disp.shape[1] * 2, disp.shape[2] * 2
        disp = resize_bilinear(disp, (h2, w2)) * 2.0
        if l_guide.shape[1:3] != (h2, w2):
            l_guide = resize_bilinear(l_guide, (h2, w2))
        x = torch.cat([disp, l_guide], dim=-1).permute(0, 3, 1, 2)
        x = self.conv0(x).permute(0, 2, 3, 1)
        return torch.relu(disp + x)


def _coarse_disparity(l_feat, r_feat, max_disp, cost_filter):
    """Difference volume -> 3D filter -> soft-argmin -> (B, h, w, 1).

    ``cost_filter`` maps the (B, D, h, w, C) volume to (B, D, h, w).  The
    softmax weighs the filtered cost directly (higher = more weight), as the
    reference does (model/mobile_stereo_net.py:144-147)."""
    vol = difference_cost_volume(l_feat, r_feat, max_disp)
    cost = cost_filter(vol)
    return soft_argmin(cost, axis=1)[..., None]


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
