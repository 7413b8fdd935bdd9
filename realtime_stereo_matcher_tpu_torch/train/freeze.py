"""BatchNorm freezing and parameter groups (port of
``realtime_stereo_matcher_tpu/train/freeze.py``; reference
train_stereo.py:121-124, ``freeze_bn``, and MobileDispNetC's ``freeze`` /
``weight_parameters`` / ``bias_parameters``, model/mobile_disp_net_c.py:
414-423).

Every BatchNorm runs in eval mode -- it normalizes with its running
statistics and updates none of them -- while the rest of the network keeps
training: the model stays in train mode, so a model that returns all its
supervision heads in training still does.  The JAX package injects
``use_running_average=True`` into every BatchNorm call with a Flax method
interceptor; in torch that is the modules' own eval flag, set for the
duration of a forward by :func:`frozen_bn`.  The trainer wires it through
``train.freeze_bn: true``.  ``frozen_bn`` pins every ``_BatchNorm``,
V4's ``GroupedBatchNorm2d`` among them.

The JAX package's optax label trees (``weight_bias_labels``,
``freeze_labels``) become labels by parameter name here: torch's
``weight`` (conv kernels and norm scales) and ``bias``, the reference's two
parameter groups; :func:`parameter_groups` hands them to a torch optimizer
and :func:`freeze` clears ``requires_grad`` on the frozen labels.
"""

from __future__ import annotations

import contextlib

from torch import nn


@contextlib.contextmanager
def frozen_bn(model: nn.Module):
    """Put every BatchNorm of ``model`` in eval mode for the block, and
    give each its own mode back afterwards."""
    bns = [m for m in model.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    modes = [m.training for m in bns]
    for m in bns:
        m.eval()
    try:
        yield model
    finally:
        for m, mode in zip(bns, modes):
            m.train(mode)


def weight_bias_labels(model: nn.Module) -> dict[str, str]:
    """Parameter name -> ``"bias"`` for biases, ``"weight"`` for the rest
    (conv kernels and norm scales): the reference's parameter groups."""
    return {name: "bias" if name.rsplit(".", 1)[-1] == "bias" else "weight"
            for name, _ in model.named_parameters()}


def freeze_labels(model: nn.Module, frozen=("weight", "bias")
                  ) -> dict[str, str]:
    """:func:`weight_bias_labels` with every label in ``frozen`` replaced by
    ``"frozen"`` (the reference ``MobileDispNetC.freeze`` freezes both)."""
    return {name: "frozen" if label in frozen else label
            for name, label in weight_bias_labels(model).items()}


def parameter_groups(model: nn.Module) -> list[dict]:
    """The torch optimizer groups ``[{"name": "weight", "params": [...]},
    {"name": "bias", "params": [...]}]`` in parameter order."""
    labels = weight_bias_labels(model)
    return [{"name": group,
             "params": [p for name, p in model.named_parameters()
                        if labels[name] == group]}
            for group in ("weight", "bias")]


def freeze(model: nn.Module, frozen=("weight", "bias")) -> None:
    """Clear ``requires_grad`` on every parameter whose label is in
    ``frozen``."""
    labels = freeze_labels(model, frozen)
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)
