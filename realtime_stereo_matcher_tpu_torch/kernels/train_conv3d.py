"""Differentiable 3x3x3 convolution of the training path (port of the TPU
kernel K6 ``flat_conv3d`` of ``realtime_stereo_matcher_tpu/kernels/train_conv3d.py``).

:func:`flat_conv3d` is a ``torch.autograd.Function`` on (B, D, H, W, C)
volumes with DHWIO weights: a pure SAME conv whose forward is K3 with an
identity epilogue, whose dx is K3 on the cotangent with the kernel flipped in
z, y and x and its channels transposed, and whose dW is the 3x3x3 form of K4
(:func:`~realtime_stereo_matcher_tpu_torch.kernels.train_conv.dw_reduce3d`).
The JAX package computed that dW with 18 XLA dots over its lane-folded flat
volume; here it is one launch of the hand-written kernel.  On CPU tensors
every step runs its plain version.
"""

from __future__ import annotations

import torch

from realtime_stereo_matcher_tpu_torch.kernels.cost_filter3d import fused_conv3d
from realtime_stereo_matcher_tpu_torch.kernels.train_conv import (
    _identity_epilogue,
    dw_reduce3d,
)


def _conv3d(x, w):
    """Pure SAME 3x3x3 conv on K3 (or its plain version on the CPU), in x's
    dtype; w DHWIO of any float type."""
    scale, bias = _identity_epilogue(w.shape[-1], x.device)
    return fused_conv3d(x, w.to(x.dtype).contiguous(), scale, bias, relu=False)


class _FlatConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        return _conv3d(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv3d(g, w.flip((0, 1, 2)).transpose(3, 4))
        if ctx.needs_input_grad[1]:
            dw = dw_reduce3d(x, g).to(w.dtype)
        return dx, dw


def flat_conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable SAME 3x3x3 conv on (B, D, H, W, C_in) ``x`` with
    DHWIO weights ``w``; forward and dx on K3, dW on K4's 3D form.  The
    output is in x's dtype."""
    return _FlatConv3d.apply(x, w)
