"""Differentiable 3x3 convolution of the training path (port of the TPU
kernels K4 ``dw_reduce`` and K5 ``flat_conv3x3`` of
``realtime_stereo_matcher_tpu/kernels/train_conv.py``).

* :func:`dw_reduce` -- the weight gradient of a stride-1 SAME 3x3 conv with
  dilation d, on NHWC tensors::

      dW[ky, kx, ci, co] = sum_{b,y,x} x[b, y+(ky-1)d, x+(kx-1)d, ci] g[b, y, x, co]

  float32 whatever the inputs' type.  :func:`dw_reduce3d` is its 3x3x3 form,
  the dW of :func:`~realtime_stereo_matcher_tpu_torch.kernels.train_conv3d.flat_conv3d`.
  On a CUDA tensor both launch a hand-written kernel of ``csrc/dw_reduce.cu``
  (counted as ``dw_reduce``, one count a call, its fixed-order sum of
  partials included): bf16, every pair, the tensor-core kernel
  (``rsm_dw_reduce_tc``, ``csrc/dw_tc.cuh``) by the plan of
  :func:`dw_tc_plan`, float32 the CUDA-core kernel (``rsm_dw_reduce``); on
  a CPU tensor they run :func:`dw_reduce_plain` / :func:`dw_reduce3d_plain`.
* :func:`flat_conv3x3` -- a ``torch.autograd.Function``: a pure conv (no
  epilogue) whose forward is K1 with an identity epilogue, whose dx is K1 on
  the cotangent with the weights rotated 180 degrees and channel-transposed
  (the adjoint of a SAME conv is a SAME conv), and whose dW is K4.
* :func:`conv3x3_s2` -- the TPU kernel K7 ``conv3x3_s2``: a stride-2 3x3
  conv (torch padding 1) whose forward is plain ``F.conv2d``, as the JAX
  forward is plain XLA, and whose backward runs on the zero-upsampled
  cotangent ``u[:, 2i, 2j] = g[:, i, j]``: dx is K1 at stride 1 on ``u``
  with the rotated, channel-transposed weights, dW is K4 of ``(x, u)``.
  No model path calls it: in the JAX package it lost to XLA's own stride-2
  backward (JAX models/fast_train.py:247-250), and the encoders here keep
  cuDNN as the JAX encoder keeps XLA.

The JAX package ran these on its lane-folded flat layout (4 pixels x 32
channels per 128 lanes, pixel phases, zero gap rows between images); none of
that is carried over.  The functions take the JAX package's NHWC layout and
HWIO weights of any float type; the conv runs in the activation's type.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from realtime_stereo_matcher_tpu_torch import stats_dtype
from realtime_stereo_matcher_tpu_torch.kernels import _build
from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    SMEM_RESERVED,
    TC_NARROW_PIX_BYTES,
    TC_PIX_BYTES,
    Card,
    _pick_steps,
    card_of,
    fused_conv3x3,
)

KERNEL_NAME = "dw_reduce"
# (C_in, C_out) pairs csrc/dw_reduce.cu instantiates, by depth taps (1: 2D)
SUPPORTED_CHANNELS = {1: {(32, 32), (4, 32), (7, 32), (32, 1)},
                      3: {(32, 32), (32, 1)}}
MAX_DILATION = 8  # the kernel stages a halo of 8 columns

# The tensor-core kernel of csrc/dw_tc.cuh (bf16, every pair): steps of 8
# rows of g, one partial dW of 9 x C_in x C_out floats a block for each depth
# tap, 12 warps; 160 registers a thread at 32 -> 32 (one block an SM), 80 at
# a narrow pair (two).  A 32-channel operand is staged 64 bytes a pixel, a
# narrow one 16.
DW_TC_ROWS = 8
DW_TC_OUT = 9 * 32 * 32
DW_TC_THREADS = 384
DW_TC_PRE = 2  # narrow pixels a thread stages ahead (csrc kDwPre)
# strip widths a plan may take: a staged 32-channel x row of tw + 2 d pixels
# is at most one 16-byte chunk a thread
DW_TC_WIDTHS = (16, 32, 48, 64, 80)


def _dw_pix_bytes(c: int) -> int:
    return TC_PIX_BYTES if c == 32 else TC_NARROW_PIX_BYTES


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """The tiling of one tensor-core ``dw_reduce`` launch, computed here and
    checked by the C entry point (``csrc/dw_reduce.cu`` ``launch_dw_tc``).

    The rows of g are one stack of ``n * d * h`` rows; a block owns a strip
    of ``tw`` columns and ``steps`` steps of ``th`` rows of that stack, with
    a ring of ``ring`` x rows; ``grid`` is (strips, row chunks, ``kd``), the
    grid's z being the depth tap; each block writes one partial dW to a
    workspace of ``work_floats`` floats, summed in a fixed order."""

    kd: int
    shape: tuple          # (n, d, h, w)
    dilation: int
    th: int
    tw: int
    ring: int
    steps: int
    grid: tuple
    smem: int
    work_floats: int


def dw_strip_width(w: int, dilation: int, card: Card, cin: int = 32,
                   cout: int = 32) -> int:
    """Columns of a block's strip: of ``DW_TC_WIDTHS`` whose plan fits the
    card, the one that pads ``w`` least, the widest of those (it runs more
    MMAs for each step's fixed costs, and loads less halo a pixel)."""
    def fits(tw):
        staged = ((tw + 2 * dilation) * 4 if cin == 32 else
                  DW_TC_ROWS * (tw + 2 * dilation) / DW_TC_PRE)
        return (staged <= DW_TC_THREADS and dw_tc_smem(
            tw, dilation, 2 * DW_TC_ROWS + 2 * dilation, cin, cout)
            <= card.smem_per_block)
    return min(filter(fits, DW_TC_WIDTHS),
               key=lambda tw: (-(-w // tw) * tw, -tw))


def dw_tc_smem(tw: int, dilation: int, ring: int, cin: int = 32,
               cout: int = 32) -> int:
    """Dynamic shared memory of a plan: the x ring and two g buffers, or the
    block's partial dW if that is more (csrc ``dw_smem_bytes``)."""
    stream = (ring * (tw + 2 * dilation) * _dw_pix_bytes(cin)
              + 2 * DW_TC_ROWS * tw * _dw_pix_bytes(cout))
    return max(stream, 9 * cin * cout * 4)


def dw_blocks_per_sm(smem: int, card: Card, cin: int = 32,
                     cout: int = 32) -> int:
    """Blocks of 384 threads an SM of ``card`` holds: one at 32 -> 32 (96
    accumulators a thread), up to two at a narrow pair (csrc
    ``DwPair::kBlocks``), as the shared memory allows."""
    most = 1 if (cin, cout) == (32, 32) else 2
    return max(1, min(most, card.smem_per_sm // (smem + SMEM_RESERVED)))


@functools.cache  # called on every launch
def dw_tc_plan(n: int, d: int, h: int, w: int, kd: int, dilation: int,
               card: Card, cin: int = 32, cout: int = 32) -> DwPlan:
    """Tile plan of the bf16 ``dw_reduce`` (``kd`` 1) or ``dw_reduce3d``
    (``kd`` 3) on the tensor cores, ``cin`` -> ``cout`` one of
    ``SUPPORTED_CHANNELS[kd]``.

    One block an SM at 32 -> 32 (its 12 warps hold 96 float32 accumulators
    a thread), up to two at a narrow pair (:func:`dw_blocks_per_sm`); strip
    width by :func:`dw_strip_width`; rows per block chosen so that the
    launch on ``card`` ends soonest: full waves times one block's steps
    plus two (its first step, which no MMA overlaps, and its partial's sum
    and store), which gives about one wave and so a workspace of about one
    partial a block slot."""
    th, tw = DW_TC_ROWS, dw_strip_width(w, dilation, card, cin, cout)
    ring = 2 * th + 2 * dilation
    smem = dw_tc_smem(tw, dilation, ring, cin, cout)
    tiles, strips = -(-(n * d * h) // th), -(-w // tw)
    slots = card.sms * dw_blocks_per_sm(smem, card, cin, cout)
    steps = _pick_steps(tiles, strips * kd, slots, lambda s: s + 2)
    grid = (strips, -(-tiles // steps), kd)
    return DwPlan(kd, (n, d, h, w), dilation, th, tw, ring, steps, grid,
                  smem, grid[0] * grid[1] * grid[2] * 9 * cin * cout)


def dw_reduce_plain(x: torch.Tensor, g: torch.Tensor, dilation: int = 1):
    """Plain PyTorch version: ``torch.nn.grad.conv2d_weight`` in float32.

    x (N, H, W, C_in), g (N, H, W, C_out) -> (3, 3, C_in, C_out) float32."""
    acc = stats_dtype(x.dtype)
    dw = torch.nn.grad.conv2d_weight(
        x.to(acc).permute(0, 3, 1, 2), (g.shape[-1], x.shape[-1], 3, 3),
        g.to(acc).permute(0, 3, 1, 2), padding=dilation, dilation=dilation)
    return dw.permute(2, 3, 1, 0).contiguous()


def dw_reduce3d_plain(x: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch version of the 3x3x3 form:
    ``torch.nn.grad.conv3d_weight`` in float32.

    x (B, D, H, W, C_in), g (B, D, H, W, C_out) -> (3, 3, 3, C_in, C_out)."""
    acc = stats_dtype(x.dtype)
    dw = torch.nn.grad.conv3d_weight(
        x.to(acc).permute(0, 4, 1, 2, 3), (g.shape[-1], x.shape[-1], 3, 3, 3),
        g.to(acc).permute(0, 4, 1, 2, 3), padding=1)
    return dw.permute(2, 3, 4, 1, 0).contiguous()


def _dw_launch(x, g, kd: int, dilation: int):
    """Launch csrc/dw_reduce.cu on (N, D, H, W, C) views of x and g: bf16 on
    the tensor cores (``rsm_dw_reduce_tc``), float32 on the CUDA cores
    (``rsm_dw_reduce``)."""
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
    out = torch.empty((kd, 3, 3, cin, cout), dtype=torch.float32, device=dev)
    if x.dtype == torch.bfloat16:
        plan = dw_tc_plan(n, d, h, w, kd, dilation, card_of(dev.index), cin,
                          cout)
        work = torch.empty(plan.work_floats, dtype=torch.float32, device=dev)
        rc = lib.rsm_dw_reduce_tc(
            x.data_ptr(), g.data_ptr(), work.data_ptr(), out.data_ptr(),
            plan.work_floats, n, d, h, w, cin, cout, kd, dilation, plan.th,
            plan.tw, plan.ring, plan.steps, *plan.grid, plan.smem, dev.index,
            _build.stream_of(x))
        _build.check(rc, KERNEL_NAME)
        _build.LAUNCHES[KERNEL_NAME] += 1
        return out
    size = lib.rsm_dw_workspace(n, d, h, w, cin, cout, kd, dilation)
    if size < 0:
        raise ValueError(f"dw_reduce: no kernel for {tuple(x.shape)} "
                         f"-> {cout}, depth taps {kd}, dilation {dilation}")
    work = torch.empty(size, dtype=torch.float32, device=dev)
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



S2_CHANNELS = (32, 32)  # the (C_in, C_out) conv3x3_s2 supports


class _Conv3x3S2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                     stride=2, padding=1)
        return y.permute(0, 2, 3, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        u = g.new_zeros((*x.shape[:3], g.shape[-1]))
        u[:, ::2, ::2] = g
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv_nhwc(u, w.flip((0, 1)).transpose(2, 3), 1)
        if ctx.needs_input_grad[1]:
            dw = dw_reduce(x, u, 1).to(w.dtype)
        return dx, dw


def conv3x3_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable stride-2 3x3 conv (torch padding 1) on NHWC ``x``
    (H and W even) with HWIO weights ``w``: (B, H, W, 32) -> (B, H/2, W/2,
    32) in x's dtype; forward plain, dx on K1, dW on K4 (float32, cast to
    w's dtype).  Other channel pairs and odd sizes raise."""
    if x.ndim != 4 or w.shape != (3, 3, *S2_CHANNELS) or \
            x.shape[-1] != S2_CHANNELS[0] or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(
            f"conv3x3_s2 supports {S2_CHANNELS[0]} -> {S2_CHANNELS[1]} "
            f"channels on even H and W, not x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}; other shapes are not ported (ROADMAP.md)")
    return _Conv3x3S2.apply(x, w)
