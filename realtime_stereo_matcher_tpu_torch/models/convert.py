"""JAX variables -> torch state dict for every neural model.

The inverse of the JAX package's ``import_torch_state_dict``
(``realtime_stereo_matcher_tpu/models/torch_import.py``, ``_map_v1v2``,
``_map_v3``, ``_map_v4`` and ``_map_dispnetc``): it takes the Flax
``{"params", "batch_stats"}`` tree as nested dicts of numpy arrays and
returns a state dict that the port's ``MobileStereoNet`` /
``MobileStereoNetV2`` / ``MobileStereoNetV3`` / ``MobileStereoNetV4`` /
``MobileDispNetC`` ``load_state_dict`` accepts, so weights initialised or
trained by the JAX package run in the port.  This module reads only the
array tree; it imports nothing of JAX.

V4: the JAX package lays the reducer's Conv3d kernels out for its
factorized volume (depth window and input channels folded into one axis,
depth-block major) and has no Conv3d biases: its importer folds them into
the next BatchNorm's running mean.  Here the kernels go back to the
reference's Conv3d shapes, the biases are zero and the means are kept,
which is exact in eval mode and leaves train-mode normalization as it is.

Layouts: Flax HWIO conv kernels become torch OIHW, DHWIO become OIDHW;
Flax ``ConvTranspose`` kernels (kh, kw, I, O), whose taps the JAX importer
flips, become torch ``ConvTranspose2d`` (I, O, kh, kw) with the taps flipped
back; BatchNorm scale/bias/mean/var become
weight/bias/running_mean/running_var.

The map is linear and leaf by leaf, so it carries a gradient as well: a
tree without ``batch_stats`` (``{"params": grads}``, ``grads`` shaped like
``params``) maps onto the port's parameter names alone, which is how the
tests hold the port's gradients against ``jax.grad``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _kernel(k) -> torch.Tensor:
    """Flax HWIO / DHWIO -> torch OIHW / OIDHW."""
    k = np.asarray(k, np.float32)
    return _tensor(np.moveaxis(k, (-1, -2), (0, 1)))


def _kernel_transposed(k) -> torch.Tensor:
    """Flax ConvTranspose (kh, kw, I, O), taps flipped -> torch (I, O, kh, kw)
    (the inverse of the JAX package's ``_t_convt2d``)."""
    k = np.asarray(k, np.float32)[::-1, ::-1]
    return _tensor(np.transpose(k, (2, 3, 0, 1)))


class _Exporter:
    def __init__(self, variables: Mapping):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats")
        self.sd: dict[str, torch.Tensor] = {}

    def conv(self, p: Mapping, tkey: str, kernel=_kernel):
        self.sd[f"{tkey}.weight"] = kernel(p["kernel"])
        if "bias" in p:
            self.sd[f"{tkey}.bias"] = _tensor(p["bias"])

    def bn(self, p: Mapping, s: Mapping | None, bn_key: str):
        """Flax BatchNorm params ``p`` and stats ``s`` -> a torch BN."""
        self.sd[f"{bn_key}.weight"] = _tensor(p["scale"])
        self.sd[f"{bn_key}.bias"] = _tensor(p["bias"])
        if s is None:  # a parameter (or gradient) tree only
            return
        self.sd[f"{bn_key}.running_mean"] = _tensor(s["mean"])
        self.sd[f"{bn_key}.running_var"] = _tensor(s["var"])
        self.sd[f"{bn_key}.num_batches_tracked"] = torch.tensor(0)

    def convbn(self, p: Mapping, s: Mapping | None, conv_key: str,
               bn_key: str):
        """Flax ConvBN -> a torch conv at ``conv_key`` and its BN at ``bn_key``."""
        self.conv(p["Conv_0"], conv_key)
        self.bn(p["BatchNorm_0"], _sub(s, "BatchNorm_0"), bn_key)

    def conv_bn_seq(self, p: Mapping, s: Mapping | None, tprefix: str):
        """Flax ConvBN -> torch Sequential(Conv, BN, ReLU) at ``tprefix``."""
        self.convbn(p, s, f"{tprefix}.0", f"{tprefix}.1")

    def resblock(self, p: Mapping, s: Mapping | None, tprefix: str):
        for ci in range(2):
            self.conv_bn_seq(p[f"ConvBN_{ci}"], _sub(s, f"ConvBN_{ci}"),
                             f"{tprefix}.conv.{ci}")


def _sub(tree: Mapping | None, key: str):
    return None if tree is None else tree[key]


def _count(tree: Mapping, prefix: str) -> int:
    n = 0
    while f"{prefix}_{n}" in tree:
        n += 1
    return n


def _refine_nets(e: _Exporter, tprefix: str):
    for r in range(_count(e.params, "RefineNet")):
        p, s = e.params[f"RefineNet_{r}"], _sub(e.stats, f"RefineNet_{r}")
        tp = f"{tprefix}.{r}.conv0"
        e.conv_bn_seq(p["ConvBN_0"], _sub(s, "ConvBN_0"), f"{tp}.0")
        n_blocks = _count(p, "ResBlock")
        for b in range(n_blocks):
            e.resblock(p[f"ResBlock_{b}"], _sub(s, f"ResBlock_{b}"),
                       f"{tp}.{1 + b}")
        e.conv(p["Conv_0"], f"{tp}.{1 + n_blocks}")


def _cost_filter(e: _Exporter):
    p, s = e.params["CostFilter3D_0"], _sub(e.stats, "CostFilter3D_0")
    for j in range(4):
        # one flat Sequential: conv at 3j, BN at 3j+1, ReLU at 3j+2
        e.convbn(p[f"ConvBN_{j}"], _sub(s, f"ConvBN_{j}"),
                 f"cost_filter.{3 * j}", f"cost_filter.{3 * j + 1}")
    e.conv(p["Conv_0"], "cost_filter.12")


def _unet(e: _Exporter):
    """Flax UNetFeatureExtractor (auto-named Conv_c in call order) -> the
    port's ``down_layers`` / ``up_layers`` (JAX torch_import ``_map_v3``)."""
    p, tp = e.params["UNetFeatureExtractor_0"], "feature_extractor"
    down = _count(p, "ConvTranspose")
    e.conv(p["Conv_0"], f"{tp}.down_layers.0.0")
    c = 1
    for i in range(1, down + 1):
        for j in range(1 + (3 if i == down else 1)):  # k4s2, then 3x3 convs
            e.conv(p[f"Conv_{c}"], f"{tp}.down_layers.{i}.{2 * j}")
            c += 1
    for j in range(down):
        e.conv(p[f"ConvTranspose_{j}"], f"{tp}.up_layers.{j}.up_conv.0",
               kernel=_kernel_transposed)
        for q in range(3):
            e.conv(p[f"Conv_{c}"], f"{tp}.up_layers.{j}.merge_conv.{2 * q}")
            c += 1


def _mobilev2(e: _Exporter, p: Mapping, s: Mapping | None, tprefix: str):
    """Flax MobileV2Residual -> the reference's ``conv`` Sequential (pw at
    0, dw at 3, pw-linear at 6; the expansion the JAX importer maps)."""
    for j, ti in enumerate((0, 3, 6)):
        e.convbn(p[f"ConvBN_{j}"], _sub(s, f"ConvBN_{j}"),
                 f"{tprefix}.conv.{ti}", f"{tprefix}.conv.{ti + 1}")


def _mobilev1(e: _Exporter, p: Mapping, s: Mapping | None, tprefix: str):
    """Flax MobileV1Residual -> ``conv1`` / ``conv2`` (dw at 0, pw at 3)
    and the ``downsample`` 1x1 where it has one."""
    for j, tp in enumerate(("conv1", "conv2")):
        pj, sj = p[f"ConvBNDws_{j}"], _sub(s, f"ConvBNDws_{j}")
        for q, ti in enumerate((0, 3)):
            e.convbn(pj[f"ConvBN_{q}"], _sub(sj, f"ConvBN_{q}"),
                     f"{tprefix}.{tp}.{ti}", f"{tprefix}.{tp}.{ti + 1}")
    if "ConvBN_0" in p:
        e.conv_bn_seq(p["ConvBN_0"], _sub(s, "ConvBN_0"),
                      f"{tprefix}.downsample")


def _conv3d_from_folded(k, kd: int) -> torch.Tensor:
    """V4's folded reducer kernel (3, 3, kd * I, O), depth-block major ->
    the reference Conv3d (O, I, kd, 3, 3) (the inverse of the JAX
    importer's ``transpose(w, (3, 4, 2, 1, 0)).reshape(...)``)."""
    k = np.asarray(k, np.float32)
    kh, kw, ki, o = k.shape
    return _tensor(np.transpose(k.reshape(kh, kw, kd, ki // kd, o),
                                (4, 3, 2, 0, 1)))


def _map_v4(e: _Exporter):
    p, s = e.params, e.stats
    fp, fs = p["FeatureExtraction_0"], _sub(s, "FeatureExtraction_0")
    for j, ti in enumerate((0, 2, 4)):
        _mobilev2(e, fp[f"MobileV2Residual_{j}"],
                  _sub(fs, f"MobileV2Residual_{j}"),
                  f"feature_extraction.firstconv.{ti}")
    k = 0
    for layer, blocks in (("layer1", 3), ("layer2", 16), ("layer3", 3),
                          ("layer4", 3)):
        for b in range(blocks):
            _mobilev1(e, fp[f"MobileV1Residual_{k}"],
                      _sub(fs, f"MobileV1Residual_{k}"),
                      f"feature_extraction.{layer}.{b}")
            k += 1
    pp, ps = p["PreConv11_0"], _sub(s, "PreConv11_0")
    for j, ti in enumerate((0, 2, 4)):
        e.conv_bn_seq(pp[f"ConvBN_{j}"], _sub(ps, f"ConvBN_{j}"),
                      f"preconv11.{ti}")
    e.conv(pp["Conv_0"], "preconv11.6")

    vp, vs = p["InterweaveVolume_0"], _sub(s, "InterweaveVolume_0")
    k0 = np.asarray(vp["conv3d0"], np.float32)           # (3, 3, 8, 16)
    kernels = (_tensor(np.transpose(k0, (3, 2, 0, 1))[:, None]),
               _conv3d_from_folded(vp["conv1"], 4),
               _conv3d_from_folded(vp["cb2"]["Conv_0"]["kernel"], 2))
    bns = ((vp["bn0"], _sub(vs, "bn0")), (vp["bn1"], _sub(vs, "bn1")),
           (vp["cb2"]["BatchNorm_0"], _sub(_sub(vs, "cb2"), "BatchNorm_0")))
    for j, (kern, (bp, bs)) in enumerate(zip(kernels, bns)):
        e.sd[f"conv3d.{3 * j}.weight"] = kern
        # the JAX package folded the bias into the running mean
        e.sd[f"conv3d.{3 * j}.bias"] = torch.zeros(kern.shape[0])
        e.bn(bp, bs, f"conv3d.{3 * j + 1}")
    e.conv_bn_seq(vp["cb3"], _sub(vs, "cb3"), "volume11.0")

    for j, tp in enumerate(("dres0.0", "dres0.2", "dres1.0", "dres1.2")):
        _mobilev2(e, p[f"MobileV2Residual_{j}"],
                  _sub(s, f"MobileV2Residual_{j}"), tp)
    for h in range(3):
        hp, hs = p[f"Hourglass2D_{h}"], _sub(s, f"Hourglass2D_{h}")
        tp = f"encoder_decoder{h + 1}"
        names = ("conv1", "conv2", "conv3", "conv4", "redir2", "redir1")
        for j, name in enumerate(names):
            _mobilev2(e, hp[f"MobileV2Residual_{j}"],
                      _sub(hs, f"MobileV2Residual_{j}"), f"{tp}.{name}")
        for j, name in enumerate(("conv5", "conv6")):
            cp, cs = hp[f"ConvTransposeBN_{j}"], _sub(hs, f"ConvTransposeBN_{j}")
            e.conv(cp["ConvTranspose_0"], f"{tp}.{name}.0",
                   kernel=_kernel_transposed)
            e.bn(cp["BatchNorm_0"], _sub(cs, "BatchNorm_0"), f"{tp}.{name}.1")
    for j in range(4):
        cp, cs = p[f"Classif_{j}"], _sub(s, f"Classif_{j}")
        e.conv_bn_seq(cp["ConvBN_0"], _sub(cs, "ConvBN_0"), f"classif{j}.0")
        e.conv(cp["Conv_0"], f"classif{j}.2")


def _map_dispnetc(e: _Exporter):
    p, s = e.params, e.stats
    for j, tp in enumerate(("conv1", "conv2", "conv_redir", "conv3.0",
                            "conv3.1")):
        bp = p[f"Conv2dBlock_{j}"]["ConvBN_0"]
        e.conv(bp["Conv_0"], f"{tp}.layer.0")
        if "BatchNorm_0" in bp:  # conv3.1 has none, nor any stats
            bs = _sub(_sub(s, f"Conv2dBlock_{j}"), "ConvBN_0")
            e.bn(bp["BatchNorm_0"], _sub(bs, "BatchNorm_0"), f"{tp}.layer.1")
    for j, tp in enumerate(("res4", "res5", "res6")):
        rp, rs = p[f"ResBlockC_{j}"], _sub(s, f"ResBlockC_{j}")
        for q, (conv, bn) in enumerate((("shortcut.0", "shortcut.1"),
                                        ("conv1", "bn1"), ("conv2", "bn2"))):
            e.conv(rp[f"Conv_{q}"], f"{tp}.{conv}")
            e.bn(rp[f"BatchNorm_{q}"], _sub(rs, f"BatchNorm_{q}"),
                 f"{tp}.{bn}")
    for j, tp in enumerate(("up5", "up4", "up3", "up2", "up1")):
        up, us = p[f"UpsampleBlock_{j}"], _sub(s, f"UpsampleBlock_{j}")
        e.conv(up["ConvTranspose_0"], f"{tp}.deconv.layer.0",
               kernel=_kernel_transposed)
        if "BatchNorm_0" in up:
            e.bn(up["BatchNorm_0"], _sub(us, "BatchNorm_0"),
                 f"{tp}.deconv.layer.1")
        e.conv(up["Conv_0"], f"{tp}.predict")
        e.conv(up["ConvTranspose_1"], f"{tp}.up_predict",
               kernel=_kernel_transposed)
        e.conv(up["Conv_1"], f"{tp}.concat")
    e.conv(p["Conv_0"], "predict")


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax variables of any neural model -> port ``state_dict``; without
    ``batch_stats``, a parameter (or gradient) tree -> the port's
    parameters by name (V4's Conv3d biases, which the JAX package does not
    have, come out zero).  v1 and v2 share one layout (v2's refine entry
    kernel is (3, 3, 7, 32) where v1's is (3, 3, 4, 32))."""
    e = _Exporter(variables)
    if "InterweaveVolume_0" in e.params:  # V4
        _map_v4(e)
        return e.sd
    if "ResBlockC_0" in e.params:  # DispNetC
        _map_dispnetc(e)
        return e.sd
    if "UNetFeatureExtractor_0" in e.params:  # v3
        _unet(e)
        _cost_filter(e)
        _refine_nets(e, "refine_layers")
        return e.sd

    p, s = e.params["FeatureEncoder_0"], _sub(e.stats, "FeatureEncoder_0")
    down = _count(p, "ConvBN")
    for i in range(down):
        e.conv_bn_seq(p[f"ConvBN_{i}"], _sub(s, f"ConvBN_{i}"),
                      f"feature_extractor.{2 * i}")
        e.resblock(p[f"ResBlock_{i}"], _sub(s, f"ResBlock_{i}"),
                   f"feature_extractor.{2 * i + 1}")
    e.conv(p["Conv_0"], f"feature_extractor.{2 * down}")
    _cost_filter(e)
    _refine_nets(e, "refine_layer")
    return e.sd
