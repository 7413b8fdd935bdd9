"""JAX variables -> torch state dict for MobileStereoNet v1.

The inverse of the JAX package's ``import_torch_state_dict`` for v1
(``realtime_stereo_matcher_tpu/models/torch_import.py``, ``_map_v1v2``):
it takes the Flax ``{"params", "batch_stats"}`` tree as nested dicts of
numpy arrays and returns a state dict that ``MobileStereoNet.load_state_dict``
accepts, so weights initialised or trained by the JAX package run in the
port.  This module reads only the array tree; it imports nothing of JAX.

Layouts: Flax HWIO conv kernels become torch OIHW, DHWIO become OIDHW;
BatchNorm scale/bias/mean/var become weight/bias/running_mean/running_var.
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


class _Exporter:
    def __init__(self, variables: Mapping):
        self.params = variables["params"]
        self.stats = variables["batch_stats"]
        self.sd: dict[str, torch.Tensor] = {}

    def conv(self, p: Mapping, tkey: str):
        self.sd[f"{tkey}.weight"] = _kernel(p["kernel"])
        if "bias" in p:
            self.sd[f"{tkey}.bias"] = _tensor(p["bias"])

    def convbn(self, p: Mapping, s: Mapping, conv_key: str, bn_key: str):
        """Flax ConvBN -> a torch conv at ``conv_key`` and its BN at ``bn_key``."""
        self.conv(p["Conv_0"], conv_key)
        bn_p, bn_s = p["BatchNorm_0"], s["BatchNorm_0"]
        self.sd[f"{bn_key}.weight"] = _tensor(bn_p["scale"])
        self.sd[f"{bn_key}.bias"] = _tensor(bn_p["bias"])
        self.sd[f"{bn_key}.running_mean"] = _tensor(bn_s["mean"])
        self.sd[f"{bn_key}.running_var"] = _tensor(bn_s["var"])
        self.sd[f"{bn_key}.num_batches_tracked"] = torch.tensor(0)

    def conv_bn_seq(self, p: Mapping, s: Mapping, tprefix: str):
        """Flax ConvBN -> torch Sequential(Conv, BN, ReLU) at ``tprefix``."""
        self.convbn(p, s, f"{tprefix}.0", f"{tprefix}.1")

    def resblock(self, p: Mapping, s: Mapping, tprefix: str):
        for ci in range(2):
            self.conv_bn_seq(p[f"ConvBN_{ci}"], s[f"ConvBN_{ci}"],
                             f"{tprefix}.conv.{ci}")


def _count(tree: Mapping, prefix: str) -> int:
    n = 0
    while f"{prefix}_{n}" in tree:
        n += 1
    return n


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax MobileStereoNet v1 variables -> port ``state_dict``."""
    e = _Exporter(variables)

    p, s = e.params["FeatureEncoder_0"], e.stats["FeatureEncoder_0"]
    down = _count(p, "ConvBN")
    for i in range(down):
        e.conv_bn_seq(p[f"ConvBN_{i}"], s[f"ConvBN_{i}"],
                      f"feature_extractor.{2 * i}")
        e.resblock(p[f"ResBlock_{i}"], s[f"ResBlock_{i}"],
                   f"feature_extractor.{2 * i + 1}")
    e.conv(p["Conv_0"], f"feature_extractor.{2 * down}")

    p, s = e.params["CostFilter3D_0"], e.stats["CostFilter3D_0"]
    for j in range(4):
        # one flat Sequential: conv at 3j, BN at 3j+1, ReLU at 3j+2
        e.convbn(p[f"ConvBN_{j}"], s[f"ConvBN_{j}"], f"cost_filter.{3 * j}",
                 f"cost_filter.{3 * j + 1}")
    e.conv(p["Conv_0"], "cost_filter.12")

    for r in range(_count(e.params, "RefineNet")):
        p, s = e.params[f"RefineNet_{r}"], e.stats[f"RefineNet_{r}"]
        tp = f"refine_layer.{r}.conv0"
        e.conv_bn_seq(p["ConvBN_0"], s["ConvBN_0"], f"{tp}.0")
        n_blocks = _count(p, "ResBlock")
        for b in range(n_blocks):
            e.resblock(p[f"ResBlock_{b}"], s[f"ResBlock_{b}"], f"{tp}.{1 + b}")
        e.conv(p["Conv_0"], f"{tp}.{1 + n_blocks}")
    return e.sd
