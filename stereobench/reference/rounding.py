"""What every reference shares: float32 without TF32, and convolutions
whose operands the check's control rounds.

A reference builds each of its convolutions from :class:`Conv2d`,
:class:`Conv3d` or :class:`ConvTranspose2d` here, so that
:func:`set_operand_rounding` reaches all of them: every convolution then
rounds its input and weight to float8 (e4m3, per-tensor scale to the
format's largest value, :func:`round_fp8`) and computes in float32, the
precision below the configurations' bfloat16.  They are ``nn`` modules, so
``yardstick.conv_work`` counts them too.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

FP8 = torch.float8_e4m3fn


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to the format's largest value), back in x's type.  Where
    ``x`` needs a gradient it passes straight through (a cast's backward
    would round the gradient to float8 too, and zero the small ones)."""
    xd = x.detach()
    amax = xd.abs().amax().float().clamp(min=1e-12)
    scale = torch.finfo(FP8).max / amax
    q = ((xd.float() * scale).to(FP8).float() / scale).to(x.dtype)
    return x + (q - xd) if x.requires_grad else q


class _Rounded:
    """A convolution whose input and weight pass through ``rounding``
    first (None: unrounded)."""

    rounding: Callable | None = None

    def _operands(self, x):
        if self.rounding is None:
            return x, self.weight
        return self.rounding(x), self.rounding(self.weight)


class Conv2d(_Rounded, nn.Conv2d):
    def forward(self, x):
        x, w = self._operands(x)
        return self._conv_forward(x, w, self.bias)


class Conv3d(_Rounded, nn.Conv3d):
    def forward(self, x):
        x, w = self._operands(x)
        return self._conv_forward(x, w, self.bias)


class ConvTranspose2d(_Rounded, nn.ConvTranspose2d):
    def forward(self, x):
        x, w = self._operands(x)
        return F.conv_transpose2d(x, w, self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def set_operand_rounding(model: nn.Module, rounding: Callable | None):
    """Give every convolution of ``model`` this operand rounding (None
    takes it away)."""
    for m in model.modules():
        if isinstance(m, _Rounded):
            m.rounding = rounding


@contextlib.contextmanager
def float32_exact():
    """float32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
