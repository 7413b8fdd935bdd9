"""Fused 3x3x3 convolution and the kernel-path cost filter (port of the TPU
kernel K3 of ``realtime_stereo_matcher_tpu/kernels/cost_filter3d.py``).

``fused_conv3d`` computes, on (B, D, H, W, C) volumes with SAME zero
padding in D, H and W,

    y = relu?(conv3x3x3(x, w) * scale + bias), cast to x's dtype.

On a CUDA tensor it launches a hand-written kernel of ``csrc/conv3d.cu``
(counted as ``fused_conv3d``); on a CPU tensor it runs
:func:`fused_conv3d_plain`.  There is no fallback from the one to the other.
Which kernel runs is decided by dtype and channel pair: in bf16 every pair
runs on the tensor cores (``rsm_conv3d_tc``) by the tile plan of
:func:`conv3d_tc_plan`: 32 -> 32 the implicit GEMM of ``csrc/conv_tc.cuh``,
the 32 -> 1 head and its 1 -> 32 dx those of ``csrc/conv3d_narrow_tc.cuh``;
float32 runs the CUDA-core template (``rsm_conv3d``,
``csrc/conv_common.cuh``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from realtime_stereo_matcher_tpu_torch import stats_dtype
from realtime_stereo_matcher_tpu_torch.kernels import _build
from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    TC_PIX_BYTES,
    TC_STAGE_BYTES,
    Card,
    ConvSpec,
    TcPlan,
    _pick_steps,
    card_of,
    conv_spec,
    tc_blocks_per_sm,
)

SUPPORTED_CHANNELS = {(32, 32), (32, 1), (1, 32)}
KERNEL_NAME = "fused_conv3d"
K3_TILE = (16, 32)  # (h, w) output tile of a block (csrc Tile<3>)
K3_RING = 4         # input depth slabs held in shared memory


def conv3d_tc_smem(cin: int = 32, cout: int = 32) -> int:
    """Dynamic shared memory of a 3x3x3 tensor-core plan: the weights, the
    ring of 4 slabs of 18 x 34 pixels and 8 KB of output staging (csrc
    ``smem_bytes<3>``, ``conv3d_narrow_smem_bytes``).  32 -> 32: 864 weight
    rows of 64 bytes; 32 -> 1: 288 rows ((dz, dy) x input channel) of 16,
    kx in the 8 padded output columns; 1 -> 32: 32 rows (taps) of 64, and
    2-byte pixels."""
    th, tw = K3_TILE
    slab = (th + 2) * (tw + 2)
    if (cin, cout) == (32, 32):
        weights, pix = 27 * 32 * TC_PIX_BYTES, TC_PIX_BYTES
    elif (cin, cout) == (32, 1):
        weights, pix = 9 * 32 * 16, TC_PIX_BYTES
    elif (cin, cout) == (1, 32):
        weights, pix = 32 * TC_PIX_BYTES, 2
    else:
        raise ValueError(f"no 3x3x3 tensor-core kernel for {cin} -> {cout}")
    return weights + K3_RING * slab * pix + TC_STAGE_BYTES


@functools.cache  # called on every launch
def conv3d_tc_plan(b: int, d: int, h: int, w: int, card: Card,
                   cin: int = 32, cout: int = 32) -> TcPlan:
    """Tile plan of a bf16 3x3x3 conv on the tensor cores, 32 -> 32 or a
    narrow pair (32 -> 1, 1 -> 32).

    A block owns a 16 x 32 (h, w) tile and walks along D with a ring of 4
    input slabs of 18 x 34 pixels beside its weights (32 -> 32 and 32 -> 1:
    one block per SM; 1 -> 32, whose slabs are 2-byte pixels: two).  D is
    split into chunks, each reloading its two halo slabs, chosen so that the
    launch on ``card`` ends soonest: full waves times one block's depths
    plus one for its first slabs, which no MMA overlaps."""
    th, tw = K3_TILE
    smem = conv3d_tc_smem(cin, cout)
    tiles = -(-h // th) * -(-w // tw)
    slots = card.sms * tc_blocks_per_sm(smem, card)
    steps = _pick_steps(d, tiles * b, slots, lambda s: s + 1)
    return TcPlan(3, (b, d, h, w), 1, th, tw, K3_RING, steps,
                  (tiles, -(-d // steps), b), smem)


def fused_conv3d_plain(x, w, scale, bias, *, relu=True):
    """Plain PyTorch version: float32 ``F.conv3d`` and the same epilogue
    (float64 for float64 ``x``, so that gradients can be checked).

    x (B, D, H, W, C_in), w (3, 3, 3, C_in, C_out) DHWIO, scale/bias
    (C_out,) f32.  Returns (B, D, H, W, C_out) in x's dtype."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = F.conv3d(x.to(acc).permute(0, 4, 1, 2, 3),
                 w.to(acc).permute(4, 3, 0, 1, 2), padding=1)
    y = y.permute(0, 2, 3, 4, 1) * scale.to(acc) + bias.to(acc)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()


def fused_conv3d(x, w, scale, bias, *, relu=True):
    """Fused 3x3x3 conv + scale/bias + optional ReLU on (B, D, H, W, C).

    Arguments as in :func:`fused_conv3d_plain`.  On CUDA: x and w share one
    dtype (float32 or bfloat16), scale and bias are float32, all are
    contiguous, and (C_in, C_out) is one of ``SUPPORTED_CHANNELS``.
    Routing on CUDA, by dtype: bf16 launches the tensor-core kernels
    (``rsm_conv3d_tc``) with :func:`conv3d_tc_plan` for the pair, float32
    the CUDA-core template (``rsm_conv3d``).  Both count as
    ``KERNEL_NAME``."""
    if x.device.type == "cpu":
        return fused_conv3d_plain(x, w, scale, bias, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3d: unsupported device {x.device}")
    if x.ndim != 5 or w.ndim != 5:
        raise ValueError("fused_conv3d: x must be (B, D, H, W, C) and w DHWIO")
    b, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    if (cin, cout) not in SUPPORTED_CHANNELS:
        raise ValueError(f"fused_conv3d: {cin} -> {cout} channels not "
                         f"instantiated; have {sorted(SUPPORTED_CHANNELS)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_conv3d: dtype {x.dtype} not supported")
    if b * d > 65535:
        raise ValueError("fused_conv3d: B * D exceeds the grid limit")
    dev = x.device
    _build.require(x, "x", shape=x.shape, dtype=x.dtype, device=dev)
    _build.require(w, "w", shape=(3, 3, 3, cin, cout), dtype=x.dtype,
                   device=dev)
    for name, t in (("scale", scale), ("bias", bias)):
        _build.require(t, name, shape=(cout,), dtype=torch.float32, device=dev)

    out = torch.empty((b, d, h, wd, cout), dtype=x.dtype, device=dev)
    if x.dtype == torch.bfloat16:
        plan = conv3d_tc_plan(b, d, h, wd, card_of(dev.index), cin, cout)
        rc = _build.library().rsm_conv3d_tc(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, d, h, wd, cin, cout, plan.th, plan.tw,
            plan.ring, plan.steps, *plan.grid, plan.smem, 1 if relu else 0,
            dev.index, _build.stream_of(x))
        _build.check(rc, KERNEL_NAME)
        _build.LAUNCHES[KERNEL_NAME] += 1
        return out
    rc = _build.library().rsm_conv3d(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[x.dtype], b, d, h, wd, cin, cout,
        1 if relu else 0, dev.index, _build.stream_of(x))
    _build.check(rc, KERNEL_NAME)
    _build.LAUNCHES[KERNEL_NAME] += 1
    return out


def build_cost_filter_plan(cost_filter, *, dtype=torch.bfloat16
                           ) -> list[ConvSpec]:
    """Fold a port ``CostFilter3D`` (flat Sequential: conv, BN, ReLU at 3j,
    3j+1, 3j+2 for j < 4, then a conv with bias at 12) into five specs."""
    specs = [conv_spec(cost_filter[3 * j], cost_filter[3 * j + 1],
                       dtype=dtype, act="relu") for j in range(4)]
    specs.append(conv_spec(cost_filter[12], None, dtype=dtype, act="none"))
    return specs


def fast_cost_filter(vol: torch.Tensor, specs) -> torch.Tensor:
    """(B, D, h, w, C) difference volume -> (B, D, h, w) float32 (float64
    for float64 specs) filtered cost: the kernel-path ``CostFilter3D``.  The volume is cast to the specs'
    dtype."""
    x = vol.to(specs[0].w.dtype).contiguous()
    for spec in specs:
        x = fused_conv3d(x, spec.w, spec.scale, spec.bias,
                         relu=spec.act == "relu")
    return x[..., 0].to(stats_dtype(x.dtype))
