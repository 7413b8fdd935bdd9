"""Differentiable 3x3 convolution of the training path (port of the TPU
kernels K4 ``dw_reduce`` and K5 ``flat_conv3x3`` of
``realtime_stereo_matcher_tpu/kernels/train_conv.py``).

* :func:`dw_reduce` -- the weight gradient of a stride-1 SAME 3x3 conv with
  dilation d, on NHWC tensors::

      dW[ky, kx, ci, co] = sum_{b,y,x} x[b, y+(ky-1)d, x+(kx-1)d, ci] g[b, y, x, co]

  float32 whatever the inputs' type.  :func:`dw_reduce3d` is its 3x3x3 form,
  the dW of :func:`~realtime_stereo_matcher_tpu_torch.kernels.train_conv3d.flat_conv3d`.
  On a CUDA tensor both launch the hand-written kernel of ``csrc/dw_reduce.cu``
  (counted as ``dw_reduce``); on a CPU tensor they run :func:`dw_reduce_plain`
  / :func:`dw_reduce3d_plain`.
* :func:`flat_conv3x3` -- a ``torch.autograd.Function``: a pure conv (no
  epilogue) whose forward is K1 with an identity epilogue, whose dx is K1 on
  the cotangent with the weights rotated 180 degrees and channel-transposed
  (the adjoint of a SAME conv is a SAME conv), and whose dW is K4.

The JAX package ran these on its lane-folded flat layout (4 pixels x 32
channels per 128 lanes, pixel phases, zero gap rows between images); none of
that is carried over.  The functions take the JAX package's NHWC layout and
HWIO weights of any float type; the conv runs in the activation's type.
"""

from __future__ import annotations

import torch

from realtime_stereo_matcher_tpu_torch.kernels import _build
from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import fused_conv3x3

KERNEL_NAME = "dw_reduce"
# (C_in, C_out) pairs csrc/dw_reduce.cu instantiates, by depth taps (1: 2D)
SUPPORTED_CHANNELS = {1: {(32, 32), (4, 32), (32, 1)},
                      3: {(32, 32), (32, 1)}}
MAX_DILATION = 8  # the kernel stages a halo of 8 columns


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """float64 stays float64 (for gradcheck); everything else sums in float32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def dw_reduce_plain(x: torch.Tensor, g: torch.Tensor, dilation: int = 1):
    """Plain PyTorch version: ``torch.nn.grad.conv2d_weight`` in float32.

    x (N, H, W, C_in), g (N, H, W, C_out) -> (3, 3, C_in, C_out) float32."""
    acc = _acc_dtype(x)
    dw = torch.nn.grad.conv2d_weight(
        x.to(acc).permute(0, 3, 1, 2), (g.shape[-1], x.shape[-1], 3, 3),
        g.to(acc).permute(0, 3, 1, 2), padding=dilation, dilation=dilation)
    return dw.permute(2, 3, 1, 0).contiguous()


def dw_reduce3d_plain(x: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch version of the 3x3x3 form:
    ``torch.nn.grad.conv3d_weight`` in float32.

    x (B, D, H, W, C_in), g (B, D, H, W, C_out) -> (3, 3, 3, C_in, C_out)."""
    acc = _acc_dtype(x)
    dw = torch.nn.grad.conv3d_weight(
        x.to(acc).permute(0, 4, 1, 2, 3), (g.shape[-1], x.shape[-1], 3, 3, 3),
        g.to(acc).permute(0, 4, 1, 2, 3), padding=1)
    return dw.permute(2, 3, 4, 1, 0).contiguous()


def _dw_launch(x, g, kd: int, dilation: int):
    """Launch csrc/dw_reduce.cu on (N, D, H, W, C) views of x and g."""
    n, d, h, w, cin = x.shape
    cout = g.shape[-1]
    if (cin, cout) not in SUPPORTED_CHANNELS[kd]:
        raise ValueError(f"dw_reduce: {cin} -> {cout} channels not "
                         f"instantiated; have {sorted(SUPPORTED_CHANNELS[kd])}")
    if not 1 <= dilation <= (MAX_DILATION if kd == 1 else 1):
        raise ValueError(f"dw_reduce: dilation {dilation} not supported")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dw_reduce: dtype {x.dtype} not supported")
    if n * d > 65535:
        raise ValueError("dw_reduce: N * D exceeds the grid limit")
    dev = x.device
    _build.require(x, "x", shape=x.shape, dtype=x.dtype, device=dev)
    _build.require(g, "g", shape=(n, d, h, w, cout), dtype=x.dtype, device=dev)
    lib = _build.library()
    size = lib.rsm_dw_workspace(n, d, h, w, cin, cout, kd, dilation)
    if size < 0:
        raise ValueError(f"dw_reduce: no kernel for {tuple(x.shape)} "
                         f"-> {cout}, depth taps {kd}, dilation {dilation}")
    work = torch.empty(size, dtype=torch.float32, device=dev)
    out = torch.empty((kd, 3, 3, cin, cout), dtype=torch.float32, device=dev)
    rc = lib.rsm_dw_reduce(x.data_ptr(), g.data_ptr(), work.data_ptr(),
                           out.data_ptr(), _build.DTYPE_CODES[x.dtype], n, d,
                           h, w, cin, cout, kd, dilation, dev.index,
                           _build.stream_of(x))
    _build.check(rc, KERNEL_NAME)
    _build.LAUNCHES[KERNEL_NAME] += 1
    return out


def _on_cpu(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def dw_reduce(x: torch.Tensor, g: torch.Tensor, dilation: int = 1):
    """dW (3, 3, C_in, C_out) float32 of a stride-1 SAME 3x3 conv.

    x (N, H, W, C_in) and g (N, H, W, C_out) share one dtype (float32 or
    bfloat16 on CUDA), are contiguous, and (C_in, C_out) is one of
    ``SUPPORTED_CHANNELS[1]``; dilation is 1 to 8."""
    if _on_cpu(x, "dw_reduce"):
        return dw_reduce_plain(x, g, dilation)
    if x.ndim != 4 or g.ndim != 4:
        raise ValueError("dw_reduce: x and g must be NHWC")
    return _dw_launch(x[:, None], g[:, None], 1, dilation)[0]


def dw_reduce3d(x: torch.Tensor, g: torch.Tensor):
    """dW (3, 3, 3, C_in, C_out) float32 of a SAME 3x3x3 conv on
    (B, D, H, W, C) volumes; requirements as :func:`dw_reduce`, channel
    pairs ``SUPPORTED_CHANNELS[3]``."""
    if _on_cpu(x, "dw_reduce3d"):
        return dw_reduce3d_plain(x, g)
    if x.ndim != 5 or g.ndim != 5:
        raise ValueError("dw_reduce3d: x and g must be (B, D, H, W, C)")
    return _dw_launch(x, g, 3, 1)


def _identity_epilogue(c: int, device):
    return (torch.ones(c, dtype=torch.float32, device=device),
            torch.zeros(c, dtype=torch.float32, device=device))


def _conv_nhwc(x, w, dilation):
    """Pure SAME 3x3 conv on K1 (or its plain version on the CPU), in x's
    dtype; w HWIO of any float type."""
    scale, bias = _identity_epilogue(w.shape[-1], x.device)
    return fused_conv3x3(x, w.to(x.dtype).contiguous(), scale, bias,
                         dilation=dilation, act="none")


class _FlatConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dilation):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        return _conv_nhwc(x, w, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the adjoint of a SAME conv: rot180, in/out channels swapped
            dx = _conv_nhwc(g, w.flip((0, 1)).transpose(2, 3), ctx.dilation)
        if ctx.needs_input_grad[1]:
            dw = dw_reduce(x, g, ctx.dilation).to(w.dtype)
        return dx, dw, None


def flat_conv3x3(x: torch.Tensor, w: torch.Tensor, dilation: int = 1):
    """Differentiable SAME 3x3 conv (stride 1, dilation d) on NHWC ``x``
    with HWIO weights ``w``; forward and dx on K1, dW on K4.

    The output is in x's dtype; the weight gradient is float32 from K4, cast
    to w's dtype."""
    return _FlatConv3x3.apply(x, w, dilation)

