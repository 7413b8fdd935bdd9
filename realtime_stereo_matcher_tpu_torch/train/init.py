"""Reference train-start weight init (port of
``realtime_stereo_matcher_tpu/train/init.py`` for v1).

The reference re-initializes at train start (train_stereo.py:127-135): every
``Conv2d`` kernel gets ``kaiming_normal_(mode="fan_out",
nonlinearity="relu")``, every BatchNorm scale 1 / bias 0 (running mean 0,
var 1).  What that loop does not touch keeps torch's default init: the
``Conv3d`` kernels of the cost filter and every conv bias,
U(+-1/sqrt(fan_in)).  Values are drawn from a CPU ``torch.Generator`` in
module order, then copied to the parameters' device, so a seed gives the same
weights on every device.  A ``torch.Generator`` does not give ``jax.random``'s
numbers: the JAX package's init is matched in distribution, not value.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _draw(shape, generator, fn) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    fn(t, generator)
    return t


@torch.no_grad()
def reference_initialize(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize ``model`` in place with the reference's train-start
    distribution (see the module docstring)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            fan_in = m.weight[0].numel()
            if isinstance(m, nn.Conv3d):
                bound = 1.0 / math.sqrt(fan_in)
                w = _draw(m.weight.shape, generator,
                          lambda t, g: t.uniform_(-bound, bound, generator=g))
            else:
                fan_out = m.out_channels * m.weight[0, 0].numel()
                std = math.sqrt(2.0 / fan_out)
                w = _draw(m.weight.shape, generator,
                          lambda t, g: t.normal_(0.0, std, generator=g))
            m.weight.copy_(w)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(fan_in)
                m.bias.copy_(_draw(m.bias.shape, generator,
                                   lambda t, g: t.uniform_(-bound, bound,
                                                           generator=g)))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.reset_running_stats()
