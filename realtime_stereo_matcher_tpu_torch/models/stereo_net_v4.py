"""MobileStereoNetV4, plain PyTorch (port of ``realtime_stereo_matcher_tpu/models/stereo_net_v4.py``;
reference model/mobile_stereo_net_v4.py:291-524).

A MobileNet encoder at 1/4 resolution (320 channels, squeezed to 32 by 1x1
convs), an interweave cost volume of 48 shifts reduced by a depth-strided
Conv3d stack, MobileNetV2 aggregation and three 2D hourglasses, and a
regression head that upsamples each (48, H/4, W/4) cost trilinearly to
(``max_disp``, H, W) and takes the soft-argmin.

The reference loops over the 48 shifts, each interleaving the left features
with the right ones shifted and running the Conv3d stack on that slice.  As
in the JAX package, every shift is computed at once (:func:`interweave_cost`):

1. the first Conv3d (1 -> 16, k (8, 3, 3), stride (8, 1, 1)) is linear, so
   its response to a shift is ``convL(L)[x] + convR(R)[x - s]``: two
   convolutions of the 8 depth blocks made once, combined per shift by a
   gather, with
   the exact corrections for the zeros the reference's sliced conv saw at
   its left column (``ct``) and at the global right column (``cr``);
2. the depth-strided Conv3d layers that follow consume one depth window an
   output, so each is a 2D conv over one output's depth window folded into
   channels (the blocks on the batch axis), batched over all shifts;
3. columns x < s are zeroed after every layer and on the output, so each
   conv sees the zero padding of the reference's sliced conv.

Train mode normalizes the volume's BatchNorms over all 48 shifts at once,
the JAX package's deliberate deviation from the reference (which calls each
BatchNorm3d once a shift); eval mode is identical.  Train mode runs the
extractor and the 1x1 squeeze once over ``[left; right]``, whose BatchNorms
normalize each view by its own statistics (``GroupedBatchNorm2d``); eval
runs them a view at a time.  Train mode returns the 4 supervision heads,
eval mode the last one.  Inputs pad to a multiple of 16 inside the model
and every head is cropped back.

Module attribute names are the reference's, so ``state_dict()`` keys are the
ones the JAX package's importer reads (``torch_import._map_v4``): the
Conv3d stack is ``conv3d.{0,3,6}`` with its BatchNorms at ``conv3d.{1,4,7}``
(the reference's layer shapes, with biases), and the 16 -> 1 reducer
``volume11.0``.  The JAX package folds the Conv3d biases into the next
BatchNorm's running mean; ``models/convert.py`` maps its variables in with
zero biases.  No TPU kernel ran on this model in the JAX package, and no
kernel of the port runs here: convolutions are cuDNN's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from realtime_stereo_matcher_tpu_torch.models.layers import (
    BN_EPS,
    BN_MOMENTUM,
    BatchNorm2d,
    BatchNorm3d,
    ConvTransposeBN,
    MobileV1Residual,
    MobileV2Residual,
    conv_bn,
    normalize_images,
)
from realtime_stereo_matcher_tpu_torch.ops import (
    pad_to_multiple,
    soft_argmin_trilinear,
)

# the model pads its inputs to a multiple of this (two stride-2 stages in
# the extractor, two in each hourglass)
ALIGN = 16
# interleaved channels of the volume (32 left, 32 right), its depth blocks
VOLUME_CHANNELS, DEPTH_BLOCKS = 64, 8


class FeatureExtraction(nn.Module):
    """MobileNet encoder at 1/4 resolution -> the 320-channel concat of
    layers 2, 3 and 4 (reference mobile_stereo_net_v4.py:151-205, JAX
    ``FeatureExtraction``).  ``bn_groups=2``: in train mode the batch holds
    [left; right] and each view is normalized by its own statistics.  NCHW."""

    def __init__(self, bn_groups: int = 2):
        super().__init__()
        er, bg = 3, bn_groups
        self.firstconv = nn.Sequential(
            MobileV2Residual(3, 32, 2, er, bn_groups=bg), nn.ReLU(),
            MobileV2Residual(32, 32, 1, er, bn_groups=bg), nn.ReLU(),
            MobileV2Residual(32, 32, 1, er, bn_groups=bg), nn.ReLU())

        def make_layer(in_ch, out_ch, blocks, stride, pad, dilation):
            down = stride != 1 or in_ch != out_ch
            return nn.Sequential(
                MobileV1Residual(in_ch, out_ch, stride, down, pad, dilation,
                                 bn_groups=bg),
                *[MobileV1Residual(out_ch, out_ch, 1, False, pad, dilation,
                                   bn_groups=bg) for _ in range(1, blocks)])

        self.layer1 = make_layer(32, 32, 3, 1, 1, 1)     # 1/2
        self.layer2 = make_layer(32, 64, 16, 2, 1, 1)    # 1/4
        self.layer3 = make_layer(64, 128, 3, 1, 1, 1)
        self.layer4 = make_layer(128, 128, 3, 1, 1, 2)   # dilated

    def forward(self, x):
        x = self.layer1(self.firstconv(x))
        l2 = self.layer2(x)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        return torch.cat([l2, l3, l4], dim=1)


class PreConv11(nn.Sequential):
    """1x1 squeeze 320 -> 256 -> 128 -> 64 -> 32 (reference :307-315): three
    conv + BN + ReLU, then a conv with bias.  NCHW."""

    def __init__(self, bn_groups: int = 2):
        layers, c = [], 320
        for out in (256, 128, 64):
            layers += [conv_bn(c, out, bn_groups=bn_groups), nn.ReLU()]
            c = out
        layers.append(nn.Conv2d(64, 32, 1, bias=True))
        super().__init__(*layers)


def _conv3d_stack() -> nn.Sequential:
    """The reference's per-shift reducer (mobile_stereo_net_v4.py:317-333):
    Conv3d 1 -> 16 (k (8, 3, 3)), 16 -> 32 (k (4, 3, 3)) and 32 -> 16
    (k (2, 3, 3)), each with a depth stride equal to its depth extent, a
    bias, a BatchNorm3d and a ReLU."""
    layers = []
    for cin, cout, kd in ((1, 16, 8), (16, 32, 4), (32, 16, 2)):
        layers += [nn.Conv3d(cin, cout, (kd, 3, 3), stride=(kd, 1, 1),
                             padding=(0, 1, 1), bias=True),
                   BatchNorm3d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
                   nn.ReLU()]
    return nn.Sequential(*layers)


def _depth_bn(bn: nn.Module, y: torch.Tensor, blocks: int) -> torch.Tensor:
    """BatchNorm3d ``bn`` over (N, blocks * C, H, W) laid out depth-block
    major: normalized as (N, C, blocks, H, W)."""
    n, _, h, w = y.shape
    y5 = y.view(n, blocks, -1, h, w).transpose(1, 2)
    return bn(y5).transpose(1, 2).reshape(n, -1, h, w)


def _folded_kernel(conv: nn.Conv3d) -> torch.Tensor:
    """Conv3d weight (O, I, kd, 3, 3) -> a 2D kernel (O, kd * I, 3, 3) over
    depth-block-major channels (channel kd_index * I + i)."""
    o, i, kd = conv.weight.shape[:3]
    return conv.weight.permute(0, 2, 1, 3, 4).reshape(o, kd * i, 3, 3)


def _blockwise_conv(x: torch.Tensor, kernel: torch.Tensor, blocks: int,
                    pad=(1, 1, 1, 1), bias=None) -> torch.Tensor:
    """One 2D conv applied to each of ``blocks`` channel blocks of ``x``
    (N, blocks * I, H, W) alike -> (N, blocks * O, H, W), block-major: the
    blocks ride the batch axis.  ``pad`` is F.pad's (left, right, top,
    bottom)."""
    n, _, h, w = x.shape
    y = F.conv2d(F.pad(x, pad).reshape(n * blocks, -1, h + pad[2] + pad[3],
                                       w + pad[0] + pad[1]),
                 kernel.to(x.dtype),
                 None if bias is None else bias.to(x.dtype))
    return y.reshape(n, -1, *y.shape[2:])


def interweave_cost(conv3d: nn.Sequential, volume11: nn.Sequential,
                    feat_l: torch.Tensor, feat_r: torch.Tensor,
                    n_shifts: int, chunk: int | None = None) -> torch.Tensor:
    """The reference's interweave volume and reducer for shifts
    [0, ``n_shifts``) at once (JAX ``InterweaveVolume``,
    models/stereo_net_v4.py:106-305; see the module docstring).

    Args:
      conv3d, volume11: the model's reducer modules.
      feat_l, feat_r: (B, 32, h, w) features, NCHW.
      chunk: shifts a pass through the layers after the first (a memory
        knob; the result does not depend on it).
    Returns:
      (B, n_shifts, h, w) with columns x < s of shift s zero.
    """
    b, c, h, w = feat_l.shape
    if 2 * c != VOLUME_CHANNELS:
        raise ValueError(f"the interweave volume takes {VOLUME_CHANNELS // 2}"
                         f"-channel features, got {c}")
    conv0 = conv3d[0]
    k = conv0.weight[:, 0]                          # (16, 8, 3, 3)
    # the even window positions read the left view, the odd the right; one
    # window a depth block of 4 channels, the same kernel for the 8 blocks
    kl, kr = k[:, 0::2], k[:, 1::2]                 # (16, 4, 3, 3)
    a = _blockwise_conv(feat_l, kl, DEPTH_BLOCKS)   # (B, 128, h, w):
    bc = _blockwise_conv(feat_r, kr, DEPTH_BLOCKS)  # channel 16 * block + o
    # convL's left taps alone (they read column x - 1): at column s the
    # reference's sliced conv read zero there
    ct = _blockwise_conv(feat_l[..., :w - 1], kl[..., :1], DEPTH_BLOCKS,
                         (1, 0, 1, 1))
    # convR's right taps alone (column x + 1): at its column w - 1 - s
    cr = _blockwise_conv(feat_r[..., 1:], kr[..., 2:], DEPTH_BLOCKS,
                         (0, 1, 1, 1))
    bias0 = conv0.bias.repeat(DEPTH_BLOCKS).view(1, 1, -1, 1, 1)
    colw = torch.arange(w, device=feat_l.device)
    chunk = min(chunk or n_shifts, n_shifts)
    slabs = []
    for s0 in range(0, n_shifts, chunk):
        shifts = torch.arange(s0, min(s0 + chunk, n_shifts),
                              device=feat_l.device)
        n_s = len(shifts)
        keep = colw[None, :] >= shifts[:, None]               # (n_s, w)
        at_s = (colw[None, :] == shifts[:, None]).to(a.dtype)
        idx = (colw[None, :] - shifts[:, None]).clamp(min=0)
        stack = bc[..., idx.reshape(-1)].view(b, -1, h, n_s, w)
        z = a[:, None] + stack.permute(0, 3, 1, 2, 4)         # (B,n_s,128,h,w)
        z = z - at_s[None, :, None, None, :] * ct[:, None]
        last = (w - 1 - shifts).clamp(0, w - 1)
        cr_last = cr[..., last].permute(0, 3, 1, 2)           # (B,n_s,128,h)
        cr_last = cr_last * (shifts >= 1).to(cr.dtype)[None, :, None, None]
        z = torch.cat([z[..., :w - 1], z[..., w - 1:] - cr_last[..., None]],
                      dim=-1)
        z = (z + bias0.to(z.dtype)).reshape(b * n_s, -1, h, w)
        vol = _reduce(conv3d, volume11, z, keep, b)
        slabs.append(vol.view(b, n_s, h, w) * keep[None, :, None, :])
    return torch.cat(slabs, dim=1)


def _reduce(conv3d: nn.Sequential, volume11: nn.Sequential, z: torch.Tensor,
            keep: torch.Tensor, b: int) -> torch.Tensor:
    """The reducer after the first conv on (B * n_s, 128, h, w), with the
    column mask ``keep`` (n_s, w) applied after every layer (JAX
    ``InterweaveVolume._tail``)."""
    n, _, h, w = z.shape
    full = keep[None, :, None, None, :]

    def mask(y):
        return (y.view(b, -1, y.shape[1], h, w) * full).view(y.shape)

    y = mask(F.relu(_depth_bn(conv3d[1], z, DEPTH_BLOCKS)))
    conv1, conv2 = conv3d[3], conv3d[6]
    y = _blockwise_conv(y, _folded_kernel(conv1), 2, bias=conv1.bias)
    y = mask(F.relu(_depth_bn(conv3d[4], y, 2)))
    y = _blockwise_conv(y, _folded_kernel(conv2), 1, bias=conv2.bias)
    y = mask(F.relu(_depth_bn(conv3d[7], y, 1)))
    return volume11(y)                                        # (N, 1, h, w)


class Hourglass2D(nn.Module):
    """2D hourglass (reference mobile_stereo_net_v4.py:223-288, JAX
    ``Hourglass2D``): two stride-2 MobileV2 stages down, two transposed
    convs up, each joined with a MobileV2 redirection of the skip.  NCHW."""

    def __init__(self, c: int):
        super().__init__()
        er = 2
        self.conv1 = MobileV2Residual(c, 2 * c, 2, er)
        self.conv2 = MobileV2Residual(2 * c, 2 * c, 1, er)
        self.conv3 = MobileV2Residual(2 * c, 4 * c, 2, er)
        self.conv4 = MobileV2Residual(4 * c, 4 * c, 1, er)
        self.conv5 = ConvTransposeBN(4 * c, 2 * c)
        self.conv6 = ConvTransposeBN(2 * c, c)
        self.redir1 = MobileV2Residual(c, c, 1, er)
        self.redir2 = MobileV2Residual(2 * c, 2 * c, 1, er)

    def forward(self, x):
        conv2 = self.conv2(self.conv1(x))
        conv4 = self.conv4(self.conv3(conv2))
        conv5 = F.relu(self.conv5(conv4) + self.redir2(conv2))
        return F.relu(self.conv6(conv5) + self.redir1(x))


def classif(c: int) -> nn.Sequential:
    """Head: conv + BN + ReLU, then a conv (reference :358-409)."""
    return nn.Sequential(conv_bn(c, c, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(c, c, 3, padding=1, bias=False))


class MobileStereoNetV4(nn.Module):
    """Reference model/mobile_stereo_net_v4.py:291-524.

    forward: (left, right) uint8-range NHWC -> (B, H, W, 1) float32
    negative disparity maps: the 4 supervision heads in train mode, the last
    one in eval mode.  ``volume_chunk`` bounds the shifts a pass through the
    volume's reducer (memory only)."""

    def __init__(self, max_disp: int = 192, volume_size: int = 48,
                 hg_size: int = 48, volume_chunk: int = 48):
        super().__init__()
        self.max_disp = max_disp
        self.volume_size = volume_size
        self.hg_size = hg_size
        self.volume_chunk = volume_chunk
        self.feature_extraction = FeatureExtraction(bn_groups=2)
        self.preconv11 = PreConv11(bn_groups=2)
        self.conv3d = _conv3d_stack()
        self.volume11 = nn.Sequential(
            nn.Sequential(nn.Conv2d(16, 1, 1, bias=False),
                          BatchNorm2d(1, eps=BN_EPS, momentum=BN_MOMENTUM)),
            nn.ReLU())
        er, hg = 3, hg_size
        self.dres0 = nn.Sequential(
            MobileV2Residual(volume_size, hg, 1, er), nn.ReLU(),
            MobileV2Residual(hg, hg, 1, er), nn.ReLU())
        self.dres1 = nn.Sequential(
            MobileV2Residual(hg, hg, 1, er), nn.ReLU(),
            MobileV2Residual(hg, hg, 1, er))
        self.encoder_decoder1 = Hourglass2D(hg)
        self.encoder_decoder2 = Hourglass2D(hg)
        self.encoder_decoder3 = Hourglass2D(hg)
        self.classif0 = classif(hg)
        self.classif1 = classif(hg)
        self.classif2 = classif(hg)
        self.classif3 = classif(hg)

    def features(self, left, right):
        """(B, 32, h, w) features of each view: one pass over [left; right]
        in train mode, a view at a time in eval mode."""
        net = lambda x: self.preconv11(self.feature_extraction(x))  # noqa: E731
        if self.training:
            feat = net(torch.cat([left, right], dim=0))
            return feat[:left.shape[0]], feat[left.shape[0]:]
        return net(left), net(right)

    def forward(self, left_img, right_img):
        dtype = self.preconv11[-1].weight.dtype
        left, orig_hw = pad_to_multiple(normalize_images(left_img, dtype),
                                        ALIGN)
        right, _ = pad_to_multiple(normalize_images(right_img, dtype), ALIGN)
        out_hw = left.shape[1:3]
        feat_l, feat_r = self.features(left.permute(0, 3, 1, 2),
                                       right.permute(0, 3, 1, 2))
        cost = interweave_cost(self.conv3d, self.volume11, feat_l, feat_r,
                               self.volume_size, self.volume_chunk)
        cost0 = self.dres0(cost)
        cost0 = self.dres1(cost0) + cost0
        out1 = self.encoder_decoder1(cost0)
        out2 = self.encoder_decoder2(out1)
        out3 = self.encoder_decoder3(out2)
        if self.training:
            costs = torch.cat([self.classif0(cost0), self.classif1(out1),
                               self.classif2(out2), self.classif3(out3)])
            preds = soft_argmin_trilinear(costs, self.max_disp,
                                          out_hw).chunk(4)
        else:
            preds = [soft_argmin_trilinear(self.classif3(out3), self.max_disp,
                                           out_hw)]
        return [-1.0 * p[:, :orig_hw[0], :orig_hw[1], None] for p in preds]
