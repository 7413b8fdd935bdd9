"""JAX variables -> torch state dict for MobileStereoNet v1, v2 and v3.

The inverse of the JAX package's ``import_torch_state_dict`` for v1, v2 and
v3 (``realtime_stereo_matcher_tpu/models/torch_import.py``, ``_map_v1v2``
and ``_map_v3``): it takes the Flax ``{"params", "batch_stats"}`` tree as
nested dicts of numpy arrays and returns a state dict that the port's
``MobileStereoNet`` / ``MobileStereoNetV2`` / ``MobileStereoNetV3``
``load_state_dict`` accepts, so
weights initialised or trained by the JAX package run in the port.  This
module reads only the array tree; it imports nothing of JAX.

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

    def convbn(self, p: Mapping, s: Mapping | None, conv_key: str,
               bn_key: str):
        """Flax ConvBN -> a torch conv at ``conv_key`` and its BN at ``bn_key``."""
        self.conv(p["Conv_0"], conv_key)
        bn_p = p["BatchNorm_0"]
        self.sd[f"{bn_key}.weight"] = _tensor(bn_p["scale"])
        self.sd[f"{bn_key}.bias"] = _tensor(bn_p["bias"])
        if s is None:  # a parameter (or gradient) tree only
            return
        bn_s = s["BatchNorm_0"]
        self.sd[f"{bn_key}.running_mean"] = _tensor(bn_s["mean"])
        self.sd[f"{bn_key}.running_var"] = _tensor(bn_s["var"])
        self.sd[f"{bn_key}.num_batches_tracked"] = torch.tensor(0)

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


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax MobileStereoNet v1, v2 or v3 variables -> port ``state_dict``;
    without ``batch_stats``, a parameter (or gradient) tree -> the port's
    parameters by name.  v1 and v2 share one layout (v2's refine entry
    kernel is (3, 3, 7, 32) where v1's is (3, 3, 4, 32))."""
    e = _Exporter(variables)
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
