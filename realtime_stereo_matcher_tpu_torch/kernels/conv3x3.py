"""Fused 3x3 and 4x4 stride-2 convolutions (port of the TPU kernels K1, K2
and K2-4x4 of ``realtime_stereo_matcher_tpu/kernels/conv3x3.py``).

``fused_conv3x3`` computes, on NHWC tensors,

    y = act(conv3x3(x, w) * scale + bias), cast to x's dtype, then + residual

with stride 1 (SAME zero padding, dilation d) or stride 2 (torch padding 1,
halving H and W), in the epilogue order of the TPU kernel: the residual is
added after the activation and the cast.  ``act`` is ``"relu"``, ``"none"``
or a float, the negative slope of a leaky ReLU.

On a CUDA tensor it launches a hand-written kernel of ``csrc/conv3x3.cu``
(stride 1 counts as ``fused_conv3x3``, stride 2 as ``fused_conv3x3_s2``, the
two TPU kernels it replaces); on a CPU tensor it runs
:func:`fused_conv3x3_plain`.  There is no fallback from the one to the other.
Which kernel runs is decided by dtype, stride and channel pair: in bf16, at
stride 1 every pair runs on the tensor cores, ``rsm_conv3x3_tc`` by the tile
plan of :func:`conv3x3_tc_plan` (32 -> 32: ``csrc/conv_tc.cuh``; a narrow
side, ``TC_NARROW``: ``csrc/conv_narrow_tc.cuh``), and at stride 2 both
pairs (32 -> 32 and the 3 -> 32 encoder stem) run ``rsm_conv_s2_tc``
(``csrc/conv_s2_tc.cuh``) by :func:`conv_s2_tc_plan`; float32 runs the
CUDA-core template (``rsm_conv3x3``, ``csrc/conv_common.cuh``).

``fused_conv4x4_s2`` is the v3 U-Net's downsampler, a 4x4 stride-2 conv with
TF-SAME padding (output pixel X reads input 2X-1 .. 2X+2, so H and W become
ceil(H / 2) and ceil(W / 2)) and the same epilogue, without a residual.  On
a CUDA tensor it launches a kernel of ``csrc/conv3x3.cu`` (counted as
``fused_conv4x4_s2``): in bf16 the tensor-core ``rsm_conv_s2_tc`` with 4
taps a side, in float32 the CUDA-core template; on a CPU tensor
:func:`fused_conv4x4_s2_plain`.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn

from realtime_stereo_matcher_tpu_torch.kernels import _build
from realtime_stereo_matcher_tpu_torch.models.layers import tf_same_pad_k4s2

# (C_in, C_out) pairs csrc/conv3x3.cu instantiates, by stride
SUPPORTED_CHANNELS = {1: {(32, 32), (4, 32), (32, 1), (32, 4), (1, 32),
                          (3, 32), (7, 32), (32, 7)},
                      2: {(32, 32), (3, 32)}}
KERNEL_NAMES = {1: "fused_conv3x3", 2: "fused_conv3x3_s2"}
KERNEL_4X4 = "fused_conv4x4_s2"
CHANNELS_4X4 = (32, 32)  # the (C_in, C_out) csrc/conv3x3.cu instantiates
_ACT_CODES = {"none": 0, "relu": 1}  # a float is leaky ReLU (code 2)

# The tensor-core kernels of csrc/conv_tc.cuh (bf16, 32 -> 32): 8 warps of 64
# output pixels, a 64-byte pixel, 1 KB of output staging per warp.  CUDA
# reserves 1 KB of an SM's shared memory for each block it holds.
TC_CHANNELS = (32, 32)
TC_PIX_BYTES = 64
TC_STAGE_BYTES = 8 * 16 * TC_PIX_BYTES
# The stride-1 pairs with a narrow side, on the tensor cores of
# csrc/conv_narrow_tc.cuh: the narrow side padded to 8 channels, a staged
# narrow pixel 16 bytes; weights 80 rows (9 taps x 8 input channels, padded
# to 5 k16 steps) of 32 output channels, or 288 rows of 8
TC_NARROW = {(1, 32), (3, 32), (4, 32), (7, 32), (32, 1), (32, 4), (32, 7)}
TC_NARROW_PIX_BYTES = 16
# The stride-2 3 -> 32 stem on the tensor cores (csrc/conv_s2_tc.cuh
# conv_s2_nin_tc_kernel): input rows of 2 x 32 + 2 staged 8-byte pixels (4
# channels), weights 48 rows (3 row taps x 4 column taps x 4 input channels)
# of 32 output channels
TC_S2_NARROW_CIN = 3
TC_S2_NARROW_PIX_BYTES = 8
SMEM_RESERVED = 1024
GRID_YZ_MAX = 65535
K1_TILE = (8, 64)   # output rows x columns of one step (csrc Tile<1>)
S2_TILE = (8, 32)   # output rows x columns of a stride-2 step (csrc kS2TH/TW)


@dataclasses.dataclass(frozen=True)
class Card:
    """What a tile plan needs of the card: its SMs and the shared memory an
    SM holds (bytes); a block may opt in to all of it but ``SMEM_RESERVED``.
    (An H100 SXM: ``Card(132, 233_472)``.)"""

    sms: int
    smem_per_sm: int

    @property
    def smem_per_block(self) -> int:
        return self.smem_per_sm - SMEM_RESERVED


@functools.cache
def card_of(index: int) -> Card:
    """The :class:`Card` of CUDA device ``index``, read once."""
    props = torch.cuda.get_device_properties(index)
    return Card(props.multi_processor_count,
                props.shared_memory_per_multiprocessor)


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """The tiling of one tensor-core launch, computed here and checked by
    the C entry point (``csrc/conv_tc.cuh`` ``launch_tc``).

    ``kd`` is 1 (3x3 conv: a block walks down a ``tw``-column strip, ``th``
    rows a step, ``steps`` steps) or 3 (3x3x3 conv: a block owns a
    ``th`` x ``tw`` (h, w) tile and walks ``steps`` depths).  ``ring`` is the
    number of input units (rows, or depth slabs) held in shared memory;
    ``smem`` the dynamic shared-memory bytes; ``grid`` (x, y, z)."""

    kd: int
    shape: tuple          # (n, d, h, w) of the output
    dilation: int
    th: int
    tw: int
    ring: int
    steps: int
    grid: tuple
    smem: int


def tc_blocks_per_sm(smem: int, card: Card) -> int:
    """Blocks of 256 threads an SM of ``card`` holds at ``smem`` dynamic
    bytes each (registers cap it at 2: the kernels' launch bounds allow 128
    a thread).  Raises if not even one fits."""
    if smem > card.smem_per_block:
        raise ValueError(f"a tensor-core plan needs {smem} B of shared memory "
                         f"a block; the card allows {card.smem_per_block}")
    return min(2, card.smem_per_sm // (smem + SMEM_RESERVED))


def _pick_steps(units: int, blocks_per_chunk: int, slots: int, cost):
    """The chunk length (1..units) whose launch ends soonest: full waves of
    ``slots`` blocks times one block's ``cost(steps)``."""
    def total(steps):
        blocks = blocks_per_chunk * -(-units // steps)
        return -(-blocks // slots) * cost(steps), -steps
    return min(range(1, units + 1), key=total)


def conv3x3_tc_smem(dilation: int, ring: int, cin: int = 32,
                    cout: int = 32) -> int:
    """Dynamic shared memory of a stride-1 tensor-core plan: the weights,
    the ring of input rows (64 + 2 d pixels each) and 8 KB of output
    staging (csrc ``smem_bytes<1>``, ``nin_smem_bytes``,
    ``nout_smem_bytes``)."""
    tw = K1_TILE[1]
    if (cin, cout) == TC_CHANNELS:
        weights, pix = 9 * 32 * TC_PIX_BYTES, TC_PIX_BYTES
    elif cout == 32:  # narrow in: 80 rows of 32 output channels
        weights, pix = 80 * TC_PIX_BYTES, TC_NARROW_PIX_BYTES
    else:             # narrow out: 288 rows of 8 output channels
        weights, pix = 9 * 32 * TC_NARROW_PIX_BYTES, TC_PIX_BYTES
    return weights + ring * (tw + 2 * dilation) * pix + TC_STAGE_BYTES


@functools.cache  # called on every launch: the frame's host time
def conv3x3_tc_plan(n: int, h: int, w: int, dilation: int, card: Card,
                    cin: int = 32, cout: int = 32) -> TcPlan:
    """Tile plan of a bf16 stride-1 3x3 conv on the tensor cores, 32 -> 32
    or a ``TC_NARROW`` pair.

    A block walks down a 64-column strip, 8 output rows a step, with a ring
    of 2 * 8 + 2 d input rows of 64 + 2 d pixels; the strips of a row band
    are neighbours in the grid (x fastest), so a dilated halo comes from L2.
    Rows per block are chosen so that the launch fills ``card``: full waves
    times the rows one block loads (its bytes: the kernel is memory-bound).
    Cached: the search costs tens of microseconds of host time a launch."""
    if (cin, cout) != TC_CHANNELS and (cin, cout) not in TC_NARROW:
        raise ValueError(f"no tensor-core kernel for {cin} -> {cout}")
    th, tw = K1_TILE
    ring = 2 * th + 2 * dilation
    smem = conv3x3_tc_smem(dilation, ring, cin, cout)
    tiles_h, tiles_w = -(-h // th), -(-w // tw)
    slots = card.sms * tc_blocks_per_sm(smem, card)
    steps = _pick_steps(tiles_h, tiles_w * n, slots,
                        lambda s: s * th + 2 * dilation)
    return TcPlan(1, (n, 1, h, w), dilation, th, tw, ring, steps,
                  (tiles_w, -(-tiles_h // steps), n), smem)


@dataclasses.dataclass(frozen=True)
class S2Plan:
    """The tiling of one stride-2 tensor-core launch (``taps`` 3 or 4 a
    side), computed here and checked by the C entry point
    (``csrc/conv_s2_tc.cuh`` ``launch_s2_tc``): a block walks down a strip
    of ``tw`` output columns, ``th`` output rows a step, ``steps`` steps,
    with a ring of ``ring`` input rows, each stored as two column-parity
    planes of ``tw + 2`` pixels; ``smem`` dynamic shared-memory bytes;
    ``grid`` (x, y, z)."""

    taps: int
    shape: tuple          # (n, h, w) of the input
    out_hw: tuple         # (ho, wo)
    th: int
    tw: int
    ring: int
    steps: int
    grid: tuple
    smem: int


def s2_ring(taps: int, th: int = S2_TILE[0]) -> int:
    """Input rows the stride-2 ring holds: a step's 2 th + taps - 2 and the
    next step's 2 th new ones."""
    return 4 * th + taps - 2


def conv_s2_tc_smem(taps: int, cin: int = 32) -> int:
    """Dynamic shared memory of a stride-2 tensor-core plan: the weights,
    the ring of ``s2_ring(taps)`` input rows (32 -> 32: two column-parity
    planes of 34 64-byte pixels; the 3 -> 32 stem: 66 8-byte pixels) and 8
    KB of output staging (csrc ``s2_smem_bytes``, ``s2_nin_smem_bytes``)."""
    tw = S2_TILE[1]
    if cin == 32:
        return (taps * taps * 32 + s2_ring(taps) * 2 * (tw + 2)) \
            * TC_PIX_BYTES + TC_STAGE_BYTES
    if (cin, taps) != (TC_S2_NARROW_CIN, 3):
        raise ValueError(f"no stride-2 tensor-core kernel for {cin} -> 32 "
                         f"with {taps} x {taps} taps")
    return 48 * TC_PIX_BYTES + s2_ring(taps) * (2 * tw + 2) \
        * TC_S2_NARROW_PIX_BYTES + TC_STAGE_BYTES


@functools.cache  # called on every launch
def conv_s2_tc_plan(n: int, h: int, w: int, taps: int, card: Card,
                    cin: int = 32) -> S2Plan:
    """Tile plan of a bf16 stride-2 conv (``taps`` x ``taps``, padding 1
    before) on the tensor cores, 32 -> 32, or 3 -> 32 with 3 taps: 8 x 32
    output tiles, a ring of ``s2_ring(taps)`` input rows beside the
    resident weights (32 -> 32: one block per SM; 3 -> 32, whose staged
    pixels are 8 bytes: two), rows per block chosen so that the
    launch on ``card`` ends soonest: full waves times the input rows one
    block loads, counting its first step's twice (no MMA overlaps their
    arrival)."""
    th, tw = S2_TILE
    ring = s2_ring(taps, th)
    smem = conv_s2_tc_smem(taps, cin)
    ho, wo = (h + 1) // 2, (w + 1) // 2
    tiles_h, tiles_w = -(-ho // th), -(-wo // tw)
    slots = card.sms * tc_blocks_per_sm(smem, card)
    steps = _pick_steps(tiles_h, tiles_w * n, slots,
                        lambda s: 2 * th * (s + 1) + taps - 2)
    return S2Plan(taps, (n, h, w), (ho, wo), th, tw, ring, steps,
                  (tiles_w, -(-tiles_h // steps), n), smem)


def _launch_s2_tc(x, w, scale, bias, out, taps: int, act_code: int,
                  alpha: float, name: str) -> None:
    """One bf16 stride-2 launch of ``rsm_conv_s2_tc`` (32 -> 32, or the
    3 -> 32 stem), counted as ``name``."""
    n, h, wd, cin = x.shape
    plan = conv_s2_tc_plan(n, h, wd, taps, card_of(x.device.index), cin)
    _build.check(_build.library().rsm_conv_s2_tc(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h, wd, *plan.out_hw, cin, taps, plan.th, plan.tw,
        plan.ring, plan.steps, *plan.grid, plan.smem, act_code, alpha,
        x.device.index, _build.stream_of(x)), name)
    _build.LAUNCHES[name] += 1


def output_hw(h: int, w: int, stride: int) -> tuple[int, int]:
    """Output size of a 3x3 conv with torch padding = dilation."""
    return ((h - 1) // stride + 1, (w - 1) // stride + 1)


def _act_code(act) -> tuple[int, float]:
    """The C interface's (act, alpha) for ``"none"``, ``"relu"`` or a slope."""
    if isinstance(act, float):
        return 2, act
    if act in _ACT_CODES:
        return _ACT_CODES[act], 0.0
    raise ValueError(f"act must be 'relu', 'none' or a float, not {act!r}")


def _activate(y: torch.Tensor, act) -> torch.Tensor:
    """The epilogue activation: ``"relu"``, ``"none"`` or a leaky slope."""
    if act == "relu":
        return torch.relu(y)
    if act == "none":
        return y
    if isinstance(act, float):
        return torch.clamp(y, min=0.0) + act * torch.clamp(y, max=0.0)
    raise ValueError(f"act must be 'relu', 'none' or a float, not {act!r}")


def fused_conv3x3_plain(x, w, scale, bias, *, stride=1, dilation=1,
                        act="relu", residual=None):
    """Plain PyTorch version: float32 ``F.conv2d`` and the same epilogue
    (float64 for float64 ``x``, so that gradients can be checked).

    x (N, H, W, C_in), w (3, 3, C_in, C_out) HWIO, scale/bias (C_out,) f32,
    residual (N, Ho, Wo, C_out) or None.  Returns (N, Ho, Wo, C_out) in
    x's dtype."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = F.conv2d(x.to(acc).permute(0, 3, 1, 2), w.to(acc).permute(3, 2, 0, 1),
                 stride=stride, padding=dilation, dilation=dilation)
    y = _activate(y.permute(0, 2, 3, 1) * scale.to(acc) + bias.to(acc), act)
    y = y.to(x.dtype)
    if residual is not None:
        y = y + residual
    return y.contiguous()


def fused_conv3x3(x, w, scale, bias, *, stride=1, dilation=1, act="relu",
                  residual=None):
    """Fused 3x3 conv + scale/bias + activation (+ residual), NHWC.

    Arguments as in :func:`fused_conv3x3_plain`.  On CUDA: x, w and residual
    share one dtype (float32 or bfloat16), scale and bias are float32, all
    are contiguous, and (C_in, C_out) is one of ``SUPPORTED_CHANNELS``.
    Routing on CUDA, by dtype and stride: bf16 at stride 1 (``TC_CHANNELS``
    and ``TC_NARROW``) launches ``rsm_conv3x3_tc`` with
    :func:`conv3x3_tc_plan`, bf16 at stride 2 (32 -> 32 and 3 -> 32)
    ``rsm_conv_s2_tc`` with :func:`conv_s2_tc_plan`; float32 the CUDA-core
    template (``rsm_conv3x3``).  All count as ``KERNEL_NAMES[stride]``."""
    if x.device.type == "cpu":
        return fused_conv3x3_plain(x, w, scale, bias, stride=stride,
                                   dilation=dilation, act=act,
                                   residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3x3: unsupported device {x.device}")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError("fused_conv3x3: x must be NHWC and w HWIO")
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    if stride not in SUPPORTED_CHANNELS:
        raise ValueError(f"fused_conv3x3: stride {stride} not supported")
    if (stride == 2 and dilation != 1) or dilation < 1:
        raise ValueError(f"fused_conv3x3: dilation {dilation} with stride {stride}")
    if (cin, cout) not in SUPPORTED_CHANNELS[stride]:
        raise ValueError(f"fused_conv3x3: {cin} -> {cout} channels at stride "
                         f"{stride} not instantiated; have "
                         f"{sorted(SUPPORTED_CHANNELS[stride])}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"fused_conv3x3: dtype {x.dtype} not supported")
    if n > 65535:
        raise ValueError("fused_conv3x3: batch exceeds the grid limit")
    ho, wo = output_hw(h, wd, stride)
    dev = x.device
    _build.require(x, "x", shape=x.shape, dtype=x.dtype, device=dev)
    _build.require(w, "w", shape=(3, 3, cin, cout), dtype=x.dtype, device=dev)
    for name, t in (("scale", scale), ("bias", bias)):
        _build.require(t, name, shape=(cout,), dtype=torch.float32, device=dev)
    if residual is not None:
        _build.require(residual, "residual", shape=(n, ho, wo, cout),
                       dtype=x.dtype, device=dev)
    act_code, alpha = _act_code(act)

    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=dev)
    name = KERNEL_NAMES[stride]
    if x.dtype == torch.bfloat16 and stride == 2:
        if residual is not None:
            raise ValueError("fused_conv3x3: the bf16 stride-2 kernel takes "
                             "no residual")
        _launch_s2_tc(x, w, scale, bias, out, 3, act_code, alpha, name)
        return out
    if x.dtype == torch.bfloat16 and stride == 1:
        plan = conv3x3_tc_plan(n, h, wd, dilation, card_of(dev.index), cin,
                               cout)
        rc = _build.library().rsm_conv3x3_tc(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), n, h, wd, cin, cout, dilation, plan.th, plan.tw,
            plan.ring, plan.steps, *plan.grid, plan.smem, act_code, alpha,
            dev.index, _build.stream_of(x))
        _build.check(rc, name)
        _build.LAUNCHES[name] += 1
        return out
    rc = _build.library().rsm_conv3x3(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(),
        _build.DTYPE_CODES[x.dtype], n, h, wd, cin, cout, ho, wo, stride,
        dilation, act_code, alpha, dev.index, _build.stream_of(x))
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return out


def fused_conv4x4_s2_plain(x, w, scale, bias, *, act=0.2):
    """Plain PyTorch version of :func:`fused_conv4x4_s2`: TF-SAME zero pad
    (1 before; 1 after an even size, 2 after an odd one), float32 stride-2
    ``F.conv2d``, then K1's epilogue (scale, bias, activation, cast).

    x (N, H, W, C_in), w (4, 4, C_in, C_out) HWIO, scale/bias (C_out,) f32.
    Returns (N, ceil(H/2), ceil(W/2), C_out) in x's dtype."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    (top, bottom), (left, right) = map(tf_same_pad_k4s2, x.shape[1:3])
    xp = F.pad(x.to(acc).permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xp, w.to(acc).permute(3, 2, 0, 1), stride=2)
    y = _activate(y.permute(0, 2, 3, 1) * scale.to(acc) + bias.to(acc), act)
    return y.to(x.dtype).contiguous()


def fused_conv4x4_s2(x, w, scale, bias, *, act=0.2):
    """Fused 4x4 stride-2 TF-SAME conv + scale/bias + activation, NHWC.

    Arguments as in :func:`fused_conv4x4_s2_plain`.  On CUDA: x and w share
    one dtype (float32 or bfloat16), scale and bias are float32, all are
    contiguous, and (C_in, C_out) is ``CHANNELS_4X4``.  bf16 launches the
    tensor-core ``rsm_conv_s2_tc`` (4 taps a side, :func:`conv_s2_tc_plan`),
    float32 the CUDA-core template (``rsm_conv4x4_s2``)."""
    if x.device.type == "cpu":
        return fused_conv4x4_s2_plain(x, w, scale, bias, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL_4X4}: unsupported device {x.device}")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"{KERNEL_4X4}: x must be NHWC and w HWIO")
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    if (cin, cout) != CHANNELS_4X4:
        raise ValueError(f"{KERNEL_4X4}: {cin} -> {cout} channels not "
                         f"instantiated; have {CHANNELS_4X4}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{KERNEL_4X4}: dtype {x.dtype} not supported")
    if n > 65535:
        raise ValueError(f"{KERNEL_4X4}: batch exceeds the grid limit")
    ho, wo = (h + 1) // 2, (wd + 1) // 2  # TF-SAME: ceil(H / 2), ceil(W / 2)
    dev = x.device
    _build.require(x, "x", shape=x.shape, dtype=x.dtype, device=dev)
    _build.require(w, "w", shape=(4, 4, cin, cout), dtype=x.dtype, device=dev)
    for name, t in (("scale", scale), ("bias", bias)):
        _build.require(t, name, shape=(cout,), dtype=torch.float32, device=dev)
    act_code, alpha = _act_code(act)

    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=dev)
    if x.dtype == torch.bfloat16:
        _launch_s2_tc(x, w, scale, bias, out, 4, act_code, alpha, KERNEL_4X4)
        return out
    rc = _build.library().rsm_conv4x4_s2(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[x.dtype], n, h, wd, cin, cout, ho,
        wo, act_code, alpha, dev.index, _build.stream_of(x))
    _build.check(rc, KERNEL_4X4)
    _build.LAUNCHES[KERNEL_4X4] += 1
    return out


def fold_bn_scale_bias(gamma, beta, mean, var, eps=1e-5):
    """BatchNorm (eval) -> per-channel float32 (scale, bias)."""
    scale = gamma.float() / torch.sqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def plain_scale_bias(bias_vec, c_out: int, device=None):
    """No-BN epilogue: identity scale and the conv bias (or zeros)."""
    scale = torch.ones(c_out, dtype=torch.float32, device=device)
    if bias_vec is None:
        return scale, torch.zeros_like(scale)
    return scale, bias_vec.detach().float().clone()


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One fused conv of a kernel stack, weights folded and laid out.

    ``w`` is HWIO (or DHWIO for the 3D conv) in the path's dtype; ``scale``
    and ``bias`` are float32.  ``res_from`` indexes the activation history of
    a stack (history[0] is the stack input, history[j] the output of conv
    j-1); that activation is added after the activation function."""

    w: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    act: str | float = "relu"
    stride: int = 1
    dilation: int = 1
    res_from: int | None = None


@torch.no_grad()
def conv_spec(conv: nn.Module, bn: nn.Module | None, *, dtype, act,
              res_from: int | None = None) -> ConvSpec:
    """Fold a torch conv (and its eval-mode BatchNorm) into a :class:`ConvSpec`."""
    k = conv.kernel_size
    if any(s != 3 for s in k) or any(p != d for p, d in zip(conv.padding,
                                                           conv.dilation)):
        raise ValueError(f"kernel path needs 3-wide SAME convs, got {conv}")
    w = conv.weight.permute(*range(2, conv.weight.ndim), 1, 0)
    if bn is not None:
        if conv.bias is not None:
            raise ValueError("a conv followed by BatchNorm must have no bias")
        scale, bias = fold_bn_scale_bias(bn.weight, bn.bias, bn.running_mean,
                                         bn.running_var, bn.eps)
    else:
        scale, bias = plain_scale_bias(conv.bias, conv.out_channels,
                                       conv.weight.device)
    return ConvSpec(w.to(dtype).contiguous(), scale.contiguous(),
                    bias.contiguous(), act, conv.stride[0], conv.dilation[0],
                    res_from)


def convbn_spec(seq: nn.Sequential, *, dtype, res_from=None) -> ConvSpec:
    """A torch ``ConvBN`` (Sequential(conv, BN, ReLU)) as a ReLU :class:`ConvSpec`."""
    return conv_spec(seq[0], seq[1], dtype=dtype, act="relu", res_from=res_from)


def run_conv(x, spec: ConvSpec, residual=None):
    """One :class:`ConvSpec` through :func:`fused_conv3x3`."""
    return fused_conv3x3(x, spec.w, spec.scale, spec.bias, stride=spec.stride,
                         dilation=spec.dilation, act=spec.act,
                         residual=residual)
