"""Reference train-start weight init (port of
``realtime_stereo_matcher_tpu/train/init.py``).

The reference re-initializes at train start (train_stereo.py:127-135): every
``Conv2d`` kernel gets ``kaiming_normal_(mode="fan_out",
nonlinearity="relu")``, every BatchNorm scale 1 / bias 0 (running mean 0,
var 1).  What that loop does not touch keeps what the model's constructor
left (JAX train/init.py:67-161):

* v1, v2, v3: torch's default init, U(+-1/sqrt(fan_in)), for the
  ``Conv3d`` kernels of the cost filter, v3's ``ConvTranspose2d``
  up-projections and every conv bias, where a transposed conv's fan-in is,
  as torch counts it, out_channels x kh x kw;
* MobileStereoNetV4: its constructor draws the ``Conv3d`` kernels from
  N(0, sqrt(2 / (out_channels x kd x kh x kw))), the fan-out Kaiming
  formula; their biases, which the JAX package folds away, start at 0; the
  hourglass ``ConvTranspose2d`` and the remaining conv bias keep torch's
  default;
* MobileDispNetC: its constructor draws the ``ConvTranspose2d`` kernels
  with fan-in Kaiming normal, N(0, sqrt(2 / fan_in)) with torch's
  transposed fan-in, and zeroes every bias.

Values are drawn from a CPU ``torch.Generator`` in module order, then copied
to the parameters' device, so a seed gives the same weights on every device.
A ``torch.Generator`` does not give ``jax.random``'s numbers: the JAX
package's init is matched in distribution, not value.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from realtime_stereo_matcher_tpu_torch.models.disp_net_c import MobileDispNetC
from realtime_stereo_matcher_tpu_torch.models.stereo_net_v4 import (
    MobileStereoNetV4,
)


def _draw(shape, generator, fn) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    fn(t, generator)
    return t


def _normal(shape, std, generator) -> torch.Tensor:
    return _draw(shape, generator,
                 lambda t, g: t.normal_(0.0, std, generator=g))


def _uniform(shape, bound, generator) -> torch.Tensor:
    return _draw(shape, generator,
                 lambda t, g: t.uniform_(-bound, bound, generator=g))


@torch.no_grad()
def reference_initialize(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize ``model`` in place with the reference's train-start
    distribution (see the module docstring)."""
    v4 = isinstance(model, MobileStereoNetV4)
    dispnet = isinstance(model, MobileDispNetC)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            # weight[0]: (C_in, k...) of a conv, (C_out, k...) of a
            # transposed one, the fan-in torch's default init uses
            fan_in = m.weight[0].numel()
            fan_out = m.out_channels * m.weight[0, 0].numel()
            if isinstance(m, nn.ConvTranspose2d) and dispnet:
                w = _normal(m.weight.shape, math.sqrt(2.0 / fan_in), generator)
            elif isinstance(m, (nn.Conv3d, nn.ConvTranspose2d)) and not (
                    v4 and isinstance(m, nn.Conv3d)):
                w = _uniform(m.weight.shape, 1.0 / math.sqrt(fan_in),
                             generator)
            else:
                w = _normal(m.weight.shape, math.sqrt(2.0 / fan_out),
                            generator)
            m.weight.copy_(w)
            if m.bias is not None:
                if dispnet or (v4 and isinstance(m, nn.Conv3d)):
                    m.bias.zero_()
                else:
                    m.bias.copy_(_uniform(m.bias.shape,
                                          1.0 / math.sqrt(fan_in), generator))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.reset_running_stats()
