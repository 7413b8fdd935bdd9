"""Model factory (port of ``realtime_stereo_matcher_tpu/models/__init__.py``).

``build_model`` takes the reference config schema
``{"type": <name>, "parameters": {...}}`` with the same type strings as the
JAX package.  MobileStereoNet v1, v2 and v3 are ported so far; the other
types are queued in ROADMAP.md.  ``is_neural`` tells the trained models
from the classical baseline, as in the JAX package.
"""

from __future__ import annotations

import torch

from realtime_stereo_matcher_tpu_torch import resolve_device
from realtime_stereo_matcher_tpu_torch.models.layers import init_parameters
from realtime_stereo_matcher_tpu_torch.models.stereo_net import (
    MobileStereoNet,
    MobileStereoNetV2,
    MobileStereoNetV3,
)

_PORTED = {"MobileStereoNet": MobileStereoNet,
           "MobileStereoNetV2": MobileStereoNetV2,
           "MobileStereoNetV3": MobileStereoNetV3}
# types the JAX package builds that the port does not have yet
_QUEUED = ("MobileStereoNetV4", "MobileDispNetC", "OpenCVSGBMModule")
# the neural types of the JAX package, ported or not
_NEURAL = (*_PORTED, "MobileStereoNetV4", "MobileDispNetC")


def build_model(model_config: dict, *, device="cuda",
                generator: torch.Generator | None = None) -> torch.nn.Module:
    """Instantiate a model in eval mode from a reference-schema config dict.

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; seed 0
    when omitted) with torch's default init, then moved to ``device``.
    """
    mtype = model_config["type"]
    if mtype not in _PORTED:
        where = ("is queued in ROADMAP.md" if mtype in _QUEUED
                 else "is not a model type of this framework")
        raise NotImplementedError(
            f"model type {mtype!r} {where}; the port has {sorted(_PORTED)}")
    dev = resolve_device(device)
    params = {k: tuple(v) if isinstance(v, list) else v
              for k, v in model_config.get("parameters", {}).items()}
    model = _PORTED[mtype](**params)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model.to(dev).eval()


def is_neural(model_config: dict) -> bool:
    """Whether the config's type is a neural network (with weights to
    load), not the classical SGBM baseline."""
    return model_config["type"] in _NEURAL


__all__ = ["MobileStereoNet", "MobileStereoNetV2", "MobileStereoNetV3",
           "build_model", "is_neural"]
