"""Plain reference of MobileStereoNet v2 and v3 for the benchmark's check.

A frozen copy of the eval-mode forward of ``MobileStereoNetV2`` and
``MobileStereoNetV3`` (``realtime_stereo_matcher_tpu_torch/models/
stereo_net.py``, ``models/layers.py``, ``ops/cost_volume.py``,
``ops/sampling.py`` and ``ops/padding.py`` at commit 5ab33e5), called with
``banded_warp=True``: the refinements warp the right guidance with the band
of the kernel path (zero outside tap offsets ``[-1, max_shift + 1]``).

It is plain PyTorch, imports nothing of the port or of JAX, and runs in
float32 with TF32 off (``rounding.float32_exact``).  In train mode its
BatchNorms follow flax, as the port's training path does (the port's
``models/layers.py`` ``_FlaxBatchNorm``).  Module names follow the
reference torch model, so the port's ``state_dict()`` loads as it is.

Its convolutions are the shared classes of ``rounding.py``, so
``rounding.set_operand_rounding`` makes it the check's control.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stereobench.reference.rounding import Conv2d, Conv3d, ConvTranspose2d

BN_EPS = 1e-5
LEAKY_SLOPE = 0.2
DIFFERENCE_FILL = 1.0


class SameConv2d(Conv2d):
    """4x4 stride-2 conv with TF-SAME zero padding: 1 before, and 1 after
    an even size or 2 after an odd one."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 4, stride=2, padding=0, bias=True)

    def forward(self, x):
        h, w = x.shape[-2:]
        return super().forward(F.pad(x, (1, 1 + w % 2, 1, 1 + h % 2)))


class _FlaxTrainMode:
    """Train mode with flax's semantics: float32 batch statistics over N
    and the spatial axes, the biased variance (clipped at 0) both to
    normalize and to update the running variance, momentum 0.9 (torch
    0.1).  Eval mode is torch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = (0, *range(2, x.ndim))
        xf = x.float()
        mu = xf.mean(dims)
        var = (xf * xf).mean(dims) - mu * mu
        var = var.clamp(min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mu)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mu.view(shape)) * mul.view(shape)
                + self.bias.view(shape)).to(x.dtype)


class BatchNorm2d(_FlaxTrainMode, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxTrainMode, nn.BatchNorm3d):
    pass


def _conv_bn(in_ch, out_ch, *, stride=1, dilation=1, ndim=2):
    conv = Conv2d if ndim == 2 else Conv3d
    bn = BatchNorm2d if ndim == 2 else BatchNorm3d
    return [conv(in_ch, out_ch, 3, stride=stride, padding=dilation,
                 dilation=dilation, bias=False),
            bn(out_ch, eps=BN_EPS), nn.ReLU()]


def conv3x3(in_ch, out_ch, stride=1, dilation=1):
    return nn.Sequential(*_conv_bn(in_ch, out_ch, stride=stride,
                                   dilation=dilation))


class ResBlock(nn.Module):
    def __init__(self, channels: int, dilation: int = 1):
        super().__init__()
        self.conv = nn.Sequential(conv3x3(channels, channels, dilation=dilation),
                                  conv3x3(channels, channels, dilation=dilation))

    def forward(self, x):
        return self.conv(x) + x


class CostFilter3D(nn.Sequential):
    """(B, D, H, W, C) volume -> (B, D, H, W): four 3x3x3 conv + BN + ReLU,
    then a 3x3x3 conv with bias to one channel."""

    def __init__(self, hidden_dim: int = 32):
        layers = []
        for _ in range(4):
            layers += _conv_bn(hidden_dim, hidden_dim, ndim=3)
        layers.append(Conv3d(hidden_dim, 1, 3, padding=1, bias=True))
        super().__init__(*layers)

    def forward(self, vol):
        x = vol.permute(0, 4, 1, 2, 3)
        for layer in self:
            x = layer(x)
        return x[:, 0]


class FeatureEncoder(nn.Sequential):
    """NHWC -> NHWC at 1 / 2^down: (stride-2 conv3x3, ResBlock) per level,
    then a 3x3 conv with bias."""

    def __init__(self, in_ch=3, hidden_dim=32, down_factor=3):
        layers, c = [], in_ch
        for _ in range(down_factor):
            layers += [conv3x3(c, hidden_dim, stride=2), ResBlock(hidden_dim)]
            c = hidden_dim
        layers.append(Conv2d(hidden_dim, hidden_dim, 3, padding=1, bias=True))
        super().__init__(*layers)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for layer in self:
            x = layer(x)
        return x.permute(0, 2, 3, 1)


def _leaky():
    return nn.LeakyReLU(LEAKY_SLOPE)


def _conv3x3_leaky(in_ch, out_ch):
    return [Conv2d(in_ch, out_ch, 3, padding=1, bias=True), _leaky()]


class UpsampleBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.up_conv = nn.Sequential(
            ConvTranspose2d(in_ch, out_ch, 2, stride=2, bias=True), _leaky())
        self.merge_conv = nn.Sequential(
            Conv2d(2 * out_ch, out_ch, 1, bias=True), _leaky(),
            *_conv3x3_leaky(out_ch, out_ch), *_conv3x3_leaky(out_ch, out_ch))

    def forward(self, x, skip):
        return self.merge_conv(torch.cat([self.up_conv(x), skip], dim=1))


class UNetFeatureExtractor(nn.Module):
    """NHWC -> the up path's pyramid, coarse to fine, NHWC."""

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


def _resize(x, out_hw, mode):
    """``F.interpolate`` over the H, W axes of NHWC ``x``."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode=mode,
                      **({} if mode == "nearest" else {"align_corners": False}))
    return y.permute(0, 2, 3, 1)


def warp_banded(image, flow, max_shift: int):
    """Sample NHWC ``image`` at ``x - flow`` (bilinear, zero outside) with
    the grid_sample renormalization of both axes; zero where the tap
    offset ``x - floor(x_pix)`` lies outside ``[-1, max_shift + 1]``."""
    b, h, w, c = image.shape
    dev = image.device
    y_pix = torch.arange(h, dtype=torch.float64, device=dev) * (h / (h - 1.0)) - 0.5
    y0 = torch.floor(y_pix).long()
    ty = (y_pix - y0).float()
    wa = (1.0 - ty) * ((y0 >= 0) & (y0 < h))
    wb = ty * ((y0 + 1 >= 0) & (y0 + 1 < h))
    rows = (image.index_select(1, y0.clamp(0, h - 1)) * wa[:, None, None]
            + image.index_select(1, (y0 + 1).clamp(0, h - 1)) * wb[:, None, None])
    gx = torch.arange(w, dtype=torch.float32, device=dev)
    x_pix = (gx - flow[..., 0].float()) * (w / (w - 1.0)) - 0.5
    x0f = torch.floor(x_pix)
    tx = x_pix - x0f
    x0 = x0f.long()
    off = torch.arange(w, device=dev) - x0
    band = (off >= -1) & (off <= max_shift + 1)
    out = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    for xi, wt in ((x0, 1.0 - tx), (x0 + 1, tx)):
        wt = wt * (band & (xi >= 0) & (xi < w))
        idx = xi.clamp(0, w - 1)[..., None].expand(b, h, w, c)
        out += torch.gather(rows.float(), 2, idx) * wt[..., None]
    return out.to(image.dtype)


class RefineNet(nn.Module):
    """Upsample the disparity 2x, warp the right guidance by it, predict a
    residual from ``disp ‖ left ‖ warped right``, ReLU."""

    def __init__(self, in_ch, hidden_dim=32, dilations=(1, 2, 4, 8, 1, 1)):
        super().__init__()
        self.conv0 = nn.Sequential(
            conv3x3(in_ch, hidden_dim),
            *[ResBlock(hidden_dim, d) for d in dilations],
            Conv2d(hidden_dim, 1, 3, padding=1, bias=True))

    def forward(self, disp, l_guide, r_guide, max_shift):
        h2, w2 = disp.shape[1] * 2, disp.shape[2] * 2
        disp = _resize(disp, (h2, w2), "bilinear") * 2.0
        if l_guide.shape[1:3] != (h2, w2):
            l_guide = _resize(l_guide, (h2, w2), "bilinear")
        if r_guide.shape[1:3] != (h2, w2):
            r_guide = _resize(r_guide, (h2, w2), "bilinear")
        r_guide = warp_banded(r_guide, disp, max_shift)
        x = torch.cat([disp, l_guide, r_guide], dim=-1).permute(0, 3, 1, 2)
        x = self.conv0(x).permute(0, 2, 3, 1)
        return torch.relu(disp + x)


def _normalize_pad(img, align):
    x = 2.0 * (img.float() / 255.0) - 1.0
    h, w = x.shape[1:3]
    x = F.pad(x, (0, 0, 0, (-w) % align, 0, (-h) % align))
    return x, (h, w)


def difference_volume(left, right, max_disp: int):
    """(B, D, H, W, C): ``left[x] - right[x - d]``, 1.0 where ``x < d``."""
    w = right.shape[2]
    idx = (torch.arange(w, device=right.device)[None, :]
           - torch.arange(max_disp, device=right.device)[:, None])
    valid = idx >= 0
    shifted = right[:, :, idx.clamp(min=0)].permute(0, 2, 1, 3, 4)
    return (left[:, None] - shifted).masked_fill(
        ~valid[None, :, None, :, None], DIFFERENCE_FILL)


def _coarse_disparity(lf, rf, vol_disp, cost_filter):
    cost = cost_filter(difference_volume(lf, rf, vol_disp)).float()
    p = torch.softmax(cost, dim=1)
    d = torch.arange(cost.shape[1], dtype=p.dtype, device=p.device)
    return (p * d.view(1, -1, 1, 1)).sum(1)[..., None]


def band_shifts(max_disp: int, down_factor: int) -> list[int]:
    """The band of each refine level: its share of ``max_disp`` + 16 px."""
    return [(max_disp >> (down_factor - 1 - i)) + 16 for i in range(down_factor)]


def _full_res(disp, out_hw, orig_hw):
    up = _resize(disp * (out_hw[1] / disp.shape[2]), out_hw, "nearest")
    return up[:, : orig_hw[0], : orig_hw[1], :]


class MobileStereoNetV2(nn.Module):
    """(left, right) uint8-range NHWC -> 3 (B, H, W, 1) negative disparity
    maps, coarse to fine; refinement i sees the right RGB warped."""

    def __init__(self, down_factor=3, max_disp=192, refine_dim=7,
                 refine_dilates=(1, 2, 4, 8, 1, 1), hidden_dim=32):
        super().__init__()
        self.down_factor, self.max_disp = down_factor, max_disp
        self.feature_extractor = FeatureEncoder(3, hidden_dim, down_factor)
        self.cost_filter = CostFilter3D(hidden_dim)
        self.refine_layer = nn.ModuleList(
            [RefineNet(refine_dim, hidden_dim, tuple(refine_dilates))
             for _ in range(down_factor)])

    def forward(self, left_img, right_img):
        align = 2 ** self.down_factor
        left, orig_hw = _normalize_pad(left_img, align)
        right, _ = _normalize_pad(right_img, align)
        x = _coarse_disparity(self.feature_extractor(left),
                              self.feature_extractor(right),
                              (self.max_disp + 1) // align, self.cost_filter)
        out = []
        for refine, shift in zip(self.refine_layer,
                                 band_shifts(self.max_disp, self.down_factor)):
            x = refine(x, left, right, shift)
            out.append(-_full_res(x, left.shape[1:3], orig_hw))
        return out


class MobileStereoNetV3(nn.Module):
    """v2 with a U-Net feature pyramid: refinement i sees pyramid level
    i + 1 of both views, the right one warped."""

    def __init__(self, down_factor=3, max_disp=192,
                 refine_dilates=(1, 2, 4, 8, 1, 1), hidden_dim=32):
        super().__init__()
        self.down_factor, self.max_disp = down_factor, max_disp
        self.feature_extractor = UNetFeatureExtractor(
            (hidden_dim,) * (down_factor + 1))
        self.cost_filter = CostFilter3D(hidden_dim)
        self.refine_layers = nn.ModuleList(
            [RefineNet(1 + 2 * hidden_dim, hidden_dim, tuple(refine_dilates))
             for _ in range(down_factor)])

    def forward(self, left_img, right_img):
        align = 2 ** self.down_factor
        left, orig_hw = _normalize_pad(left_img, align)
        right, _ = _normalize_pad(right_img, align)
        l_py = self.feature_extractor(left)
        r_py = self.feature_extractor(right)
        x = _coarse_disparity(l_py[0], r_py[0],
                              (self.max_disp + 1) // align, self.cost_filter)
        out = []
        shifts = band_shifts(self.max_disp, self.down_factor)
        for i, refine in enumerate(self.refine_layers):
            x = refine(x, l_py[i + 1], r_py[i + 1], shifts[i])
            out.append(-_full_res(x, left.shape[1:3], orig_hw))
        return out


MODELS = {"MobileStereoNetV2": MobileStereoNetV2,
          "MobileStereoNetV3": MobileStereoNetV3}


def build(model_config: dict, device="cpu") -> nn.Module:
    """The reference of a ``{"type", "parameters"}`` model section, in eval
    mode, its weights uninitialised (load a state dict into it)."""
    params = {k: tuple(v) if isinstance(v, list) else v
              for k, v in model_config.get("parameters", {}).items()}
    with torch.device(device):
        model = MODELS[model_config["type"]](**params)
    return model.eval()
