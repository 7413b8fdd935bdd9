#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds and runs on one CUDA card.

    python3 chip_smoke.py

Runs on one NVIDIA Hopper card (it exits non-zero at once without CUDA) and
imports nothing of JAX.  Phases, each timed after ``torch.cuda.synchronize()``:

1. build: compile ``realtime_stereo_matcher_tpu_torch/csrc/*.cu`` with nvcc.
2. kernels: every hand-written kernel against its plain PyTorch version at
   every distinct shape of the 720p v1 path, in float32 and bfloat16, then
   timed at its largest shape beside the plain version, one cuDNN call
   (``library_ms``) and the card's bound.
3. train kernels: K4 (``dw_reduce``, 2D and 3D) and the channel pairs the
   backward adds to K1 and K3, against their plain versions at every shape
   of the 4 x 480 x 640 training step, float32 and bfloat16; K4 timed beside
   its plain version and one cuDNN weight-gradient call.
4. autograd: ``flat_conv3x3`` and ``flat_conv3d`` backward (dx, dW) against
   the plain backward of the same functions, float32 and bfloat16.
5. model: v1 from ``configure/stereo_net_config.json`` with seeded weights
   and BatchNorm stats; the float32 kernel path against the plain float32
   model at 1280x720, the bf16 kernel path (the inference main path) with
   launch counts, then 8 stereo pairs through
   ``realtime_stereo_matcher_tpu_torch.bench``.
6. train: the reference training config (batch 4, 480 x 640 crops of seeded
   synthetic scenes) from ``create_train_state``; the first step's float32
   kernel-path loss, gradients and BatchNorm updates against the float32
   plain step, its bf16 gradients too, then ``train()`` on the kernel path
   in bf16 (the training main path) for 2 warm-up and 8 timed steps, with
   launch counts per step and step times by CUDA events.
7. report: one ``{"kernels": [...]}`` line, one latency line, the
   ``nvidia-smi`` name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no "ok".
"""

from __future__ import annotations

import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from realtime_stereo_matcher_tpu_torch import bench
from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.data.synthetic import SyntheticBatches
from realtime_stereo_matcher_tpu_torch.kernels import _build
from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    fused_conv3x3,
    fused_conv3x3_plain,
    output_hw,
)
from realtime_stereo_matcher_tpu_torch.kernels.cost_filter3d import (
    fused_conv3d,
    fused_conv3d_plain,
)
from realtime_stereo_matcher_tpu_torch.kernels.train_conv import (
    dw_reduce,
    dw_reduce3d,
    dw_reduce3d_plain,
    dw_reduce_plain,
    flat_conv3x3,
)
from realtime_stereo_matcher_tpu_torch.kernels.train_conv3d import flat_conv3d
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.fast_infer import make_fast_forward
from realtime_stereo_matcher_tpu_torch.models.fast_train import (
    fast_train_forward,
    load_running_stats,
    running_stats,
)
from realtime_stereo_matcher_tpu_torch.train.loss import build_loss_function
from realtime_stereo_matcher_tpu_torch.train.trainer import (
    create_train_state,
    restore_checkpoint,
    train,
)

SEED = 0
HW = (720, 1280)
# float32: the kernel and the plain version (cuDNN in full float32, TF32
# off) sum the same products in another order
TOL_F32 = (1e-3, 1e-3)  # (atol, rtol)
# bfloat16: the kernel rounds its output to bf16 after the activation, and
# again after the residual (<= 2^-9 relative each); the reference is the
# plain version in float32 on the same bf16-rounded inputs, unrounded
TOL_BF16 = (2e-2, 1e-2)
# K4 sums ~10^6 products per output: its tolerances are relative to the
# output's scale (its largest magnitude), atol * scale + rtol * |ref|
TOL_DW_F32 = (1e-3, 1e-3)
TOL_DW_BF16 = (2e-2, 1e-2)
# launches of one 720p frame on the inference main path
LAUNCHES_PER_FRAME = {"fused_conv3x3": 56, "fused_conv3x3_s2": 6,
                      "fused_conv3d": 5}
# the training main path: reference config, batch 4 at 480 x 640
TRAIN_B, TRAIN_HW = 4, (480, 640)
WARMUP_STEPS, TIMED_STEPS = 2, 8
# launches of one bf16 training step: K1 54 forward + 54 dx, K3 5 + 5,
# K4 54 2D + 5 3D
LAUNCHES_PER_STEP = {"fused_conv3x3": 108, "fused_conv3d": 10,
                     "dw_reduce": 59}
# first-step gradients against the float32 plain step: per-parameter
# relative L2 within max(1e-2, 6 x the plain step's own noise floor), the
# rule of tests/test_fast_train.py, the floor measured by running the plain
# step on the batch in reverse order (the same gradient, summed in another
# order); parameters whose gradient norm is < 1e-3 (zero by symmetry, e.g.
# the encoder head bias, which cancels in the difference volume) are
# skipped.  In bf16 the bound is max(5e-2, 3 x the plain step's own bf16
# distance from float32): bf16 itself moves the encoder's gradients by
# 25-75% in the plain (autocast) step, where the features' difference
# volume cancels
GRAD_RTOL_F32, GRAD_F32_FLOOR_SLACK = 1e-2, 6.0
GRAD_RTOL_BF16, GRAD_BF16_FLOOR_SLACK = 5e-2, 3.0
REPLACES = {
    "fused_conv3x3": "realtime_stereo_matcher_tpu/kernels/conv3x3.py:369",
    "fused_conv3x3_s2": "realtime_stereo_matcher_tpu/kernels/conv3x3.py:613",
    "fused_conv3d": "realtime_stereo_matcher_tpu/kernels/cost_filter3d.py:213",
    "dw_reduce": "realtime_stereo_matcher_tpu/kernels/train_conv.py:141",
}
SOURCES = {
    "fused_conv3x3": "realtime_stereo_matcher_tpu_torch/csrc/conv3x3.cu",
    "fused_conv3x3_s2": "realtime_stereo_matcher_tpu_torch/csrc/conv3x3.cu",
    "fused_conv3d": "realtime_stereo_matcher_tpu_torch/csrc/conv3d.cu",
    "dw_reduce": "realtime_stereo_matcher_tpu_torch/csrc/dw_reduce.cu",
}
ROOT = pathlib.Path(__file__).resolve().parent
# peak memory rate (bytes/s) and dense bf16 tensor-core rate (FLOP/s) from
# NVIDIA's data sheets, by card name; other cards use the H100 SXM row
PEAKS = {"H200": (4.8e12, 989e12), "H100": (3.35e12, 989e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Times a phase to the end of its device work."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            torch.cuda.synchronize()
        log(f"phase {self.name}: {time.perf_counter() - self.t0:.3f} s"
            + (" (failed)" if exc_type else ""))
        return False


# ---------------------------------------------------------------------------
# kernel cases: every distinct (kernel, shape, epilogue) of the 720p v1 path
# ---------------------------------------------------------------------------


def conv3x3_cases(h: int = HW[0], w: int = HW[1]) -> list[dict]:
    """Stride-1 and stride-2 3x3 cases of the v1 path at an h x w input."""
    cases = []
    enc = [(h >> k, w >> k) for k in (1, 2, 3)]         # encoder levels
    for hw in enc:
        for res in (False, True):                       # ResBlock convs
            cases.append(dict(hw=hw, cin=32, cout=32, stride=1, dil=1,
                              act="relu", res=res))
    cases.append(dict(hw=enc[-1], cin=32, cout=32, stride=1, dil=1,
                      act="none", res=False))           # encoder head
    for hw in reversed(enc[:2] + [(h, w)]):             # refine levels
        cases.append(dict(hw=hw, cin=4, cout=32, stride=1, dil=1, act="relu",
                          res=False))                   # entry
        for dil in (1, 2, 4, 8):
            for res in (False, True):
                cases.append(dict(hw=hw, cin=32, cout=32, stride=1, dil=dil,
                                  act="relu", res=res))
        cases.append(dict(hw=hw, cin=32, cout=1, stride=1, dil=1, act="none",
                          res=False))                   # head
    # leaky ReLU: not on the v1 path, but part of the function K1 computes
    cases.append(dict(hw=enc[1], cin=32, cout=32, stride=1, dil=2, act=0.2,
                      res=True))
    cases.append(dict(hw=(h, w), cin=3, cout=32, stride=2, dil=1, act="relu",
                      res=False))
    for hw in enc[:2]:
        cases.append(dict(hw=hw, cin=32, cout=32, stride=2, dil=1, act="relu",
                          res=False))
    unique = []
    for c in cases:
        if c not in unique:
            unique.append(c)
    return unique


def conv3d_cases(h: int = HW[0], w: int = HW[1]) -> list[dict]:
    """The 3x3x3 cases of the v1 cost filter (D = 24 at 1/8 resolution)."""
    vol = (1, 24, h >> 3, w >> 3)
    return [dict(vol=vol, cin=32, cout=32, relu=True),
            dict(vol=vol, cin=32, cout=1, relu=False)]


def _operands(shape_x, shape_w, cout, dtype, device, gen):
    x = (torch.rand(shape_x, generator=gen, device=device) * 2 - 1).to(dtype)
    fan_in = 1
    for s in shape_w[:-1]:
        fan_in *= s
    w = ((torch.rand(shape_w, generator=gen, device=device) * 2 - 1)
         / fan_in ** 0.5).to(dtype)
    scale = torch.rand(cout, generator=gen, device=device) + 0.5
    bias = (torch.rand(cout, generator=gen, device=device) - 0.5) * 0.6
    return x, w, scale, bias


def conv3x3_operands(case, dtype, device, gen):
    h, w = case["hw"]
    x, wt, scale, bias = _operands((1, h, w, case["cin"]),
                                   (3, 3, case["cin"], case["cout"]),
                                   case["cout"], dtype, device, gen)
    s = case["stride"]
    res = None
    if case["res"]:
        res = (torch.rand((1, *output_hw(h, w, s), case["cout"]),
                          generator=gen, device=device) * 2 - 1).to(dtype)
    kw = dict(stride=s, dilation=case["dil"], act=case["act"])
    return (x, wt, scale, bias), kw, res


def conv3d_operands(case, dtype, device, gen):
    args = _operands((*case["vol"], case["cin"]),
                     (3, 3, 3, case["cin"], case["cout"]), case["cout"],
                     dtype, device, gen)
    return args, dict(relu=case["relu"])


def _compare(got, ref, tol, what):
    atol, rtol = tol
    err = (got.float() - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if got.shape != ref.shape or bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {ref.numel()} values out of "
            f"tolerance (atol {atol}, rtol {rtol}), max abs err "
            f"{float(err.max()):.3e}, shapes {tuple(got.shape)} "
            f"{tuple(ref.shape)}")
    return float(err.max())


def check_kernels(device, cases2d, cases3d) -> dict:
    """Each kernel against its plain version, float32 and bf16; returns the
    largest abs error per kernel name and dtype."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst: dict = {}

    def note(name, dtype, err):
        key = (name, "f32" if dtype == torch.float32 else "bf16")
        worst[key] = max(worst.get(key, 0.0), err)

    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for case in cases2d:
            args, kw, res = conv3x3_operands(case, dtype, device, gen)
            got = fused_conv3x3(*args, **kw, residual=res)
            ref = fused_conv3x3_plain(
                *(a.float() for a in args), **kw,
                residual=None if res is None else res.float())
            name = "fused_conv3x3" if case["stride"] == 1 else "fused_conv3x3_s2"
            note(name, dtype, _compare(got, ref, tol, f"{name} {case} {dtype}"))
        for case in cases3d:
            args, kw = conv3d_operands(case, dtype, device, gen)
            got = fused_conv3d(*args, **kw)
            ref = fused_conv3d_plain(*(a.float() for a in args), **kw)
            note("fused_conv3d", dtype,
                 _compare(got, ref, tol, f"fused_conv3d {case} {dtype}"))
        log(f"  {len(cases2d) + len(cases3d)} cases within tolerance in {dtype}")
    return worst


# ---------------------------------------------------------------------------
# timing at the largest main-path shape of each kernel
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def time_kernels(device, peaks) -> dict:
    """bf16 timings at each kernel's largest main-path shape."""
    bw, flops_peak = peaks
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    rows = {}
    timed = [
        ("fused_conv3x3", dict(hw=HW, cin=32, cout=32, stride=1, dil=1,
                               act="relu", res=True)),
        ("fused_conv3x3_s2", dict(hw=(HW[0] // 2, HW[1] // 2), cin=32,
                                  cout=32, stride=2, dil=1, act="relu",
                                  res=False)),
    ]
    for name, case in timed:
        args, kw, res = conv3x3_operands(case, torch.bfloat16, device, gen)
        x, w = args[0], args[1]
        out = fused_conv3x3(*args, **kw, residual=res)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy
        s, d = case["stride"], case["dil"]
        flops = 2 * out.numel() * 9 * case["cin"]
        rows[name] = dict(
            shape=f"{case['hw'][0]}x{case['hw'][1]} {case['cin']}->"
                  f"{case['cout']} stride {s}" + (" +residual" if res is not None else ""),
            ms=time_ms(lambda: fused_conv3x3(*args, **kw, residual=res)),
            plain_ms=time_ms(lambda: fused_conv3x3_plain(*args, **kw,
                                                         residual=res)),
            library_ms=time_ms(lambda: F.conv2d(x_nchw, w_oihw, stride=s,
                                                padding=d, dilation=d)),
            bytes=_nbytes(*args, res, out), flops=flops)
    case = conv3d_cases()[0]
    args, kw = conv3d_operands(case, torch.bfloat16, device, gen)
    x, w = args[0], args[1]
    out = fused_conv3d(*args, **kw)
    w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous()
    x_ncdhw = x.permute(0, 4, 1, 2, 3)
    rows["fused_conv3d"] = dict(
        shape=f"{'x'.join(map(str, case['vol']))} {case['cin']}->{case['cout']}",
        ms=time_ms(lambda: fused_conv3d(*args, **kw)),
        plain_ms=time_ms(lambda: fused_conv3d_plain(*args, **kw)),
        library_ms=time_ms(lambda: F.conv3d(x_ncdhw, w_oidhw, padding=1)),
        bytes=_nbytes(*args, out), flops=2 * out.numel() * 27 * case["cin"])
    for row in rows.values():
        t_bytes = row["bytes"] / bw * 1e3
        t_ops = row["flops"] / flops_peak * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return rows


# ---------------------------------------------------------------------------
# training kernels: K4 and the channel pairs the backward adds to K1 and K3
# ---------------------------------------------------------------------------


def train_levels(h: int = TRAIN_HW[0], w: int = TRAIN_HW[1]):
    """(refine levels full, 1/2, 1/4; encoder ResBlock levels 1/2 to 1/8)."""
    return [(h >> k, w >> k) for k in (0, 1, 2)], \
        [(h >> k, w >> k) for k in (1, 2, 3)]


def dw_cases() -> list[dict]:
    """Every K4 launch shape of a training step: (hw, cin, cout, dil) in 2D,
    (vol, cin, cout) in 3D."""
    refine, enc = train_levels()
    cases = []
    for hw in refine:
        cases += [dict(hw=hw, cin=32, cout=32, dil=d) for d in (1, 2, 4, 8)]
        cases += [dict(hw=hw, cin=4, cout=32, dil=1),
                  dict(hw=hw, cin=32, cout=1, dil=1)]
    cases += [dict(hw=hw, cin=32, cout=32, dil=1) for hw in enc
              if hw not in refine]
    vol = (24, TRAIN_HW[0] >> 3, TRAIN_HW[1] >> 3)
    cases += [dict(vol=vol, cin=32, cout=32), dict(vol=vol, cin=32, cout=1)]
    return cases


def _compare_scaled(got, ref, tol, what):
    """|got - ref| <= atol * max|ref| + rtol * |ref|; returns the largest
    abs error and that error over max|ref|."""
    atol, rtol = tol
    scale = float(ref.abs().max())
    err = (got.float() - ref).abs()
    bad = err > atol * scale + rtol * ref.abs()
    if got.shape != ref.shape or bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {ref.numel()} values out of "
            f"tolerance (atol {atol} x scale {scale:.3e}, rtol {rtol}), max "
            f"abs err {float(err.max()):.3e}")
    return float(err.max()), float(err.max()) / max(scale, 1e-30)


def _dw_operands(case, dtype, device, gen):
    shape = (TRAIN_B, *case["vol"]) if "vol" in case else (TRAIN_B,
                                                           *case["hw"])
    x = (torch.rand((*shape, case["cin"]), generator=gen, device=device)
         * 2 - 1).to(dtype)
    g = (torch.rand((*shape, case["cout"]), generator=gen, device=device)
         * 2 - 1).to(dtype)
    return x, g


def check_train_kernels(device) -> dict:
    """K4 against its plain version at every training shape, and the new K1
    / K3 channel pairs against theirs; returns the largest errors."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    worst: dict = {}

    def note(key, err):
        worst[key] = max(worst.get(key, 0.0), err)

    refine, _ = train_levels()
    for dtype, tol, ktol, tag in ((torch.float32, TOL_DW_F32, TOL_F32, "f32"),
                                  (torch.bfloat16, TOL_DW_BF16, TOL_BF16,
                                   "bf16")):
        for case in dw_cases():
            x, g = _dw_operands(case, dtype, device, gen)
            if "vol" in case:
                got = dw_reduce3d(x, g)
                ref = dw_reduce3d_plain(x.float(), g.float())
            else:
                got = dw_reduce(x, g, case["dil"])
                ref = dw_reduce_plain(x.float(), g.float(), case["dil"])
            err, rel = _compare_scaled(got, ref, tol,
                                       f"dw_reduce {case} {dtype}")
            note(("dw_reduce", tag), err)
            note(("dw_reduce", tag, "over scale"), rel)
        # K1 32 -> 4 and 1 -> 32 (dx of the refine entry and head), K3 1 -> 32
        for hw in refine:
            for cin, cout in ((32, 4), (1, 32)):
                args = _operands((TRAIN_B, *hw, cin), (3, 3, cin, cout), cout,
                                 dtype, device, gen)
                got = fused_conv3x3(*args, act="none")
                ref = fused_conv3x3_plain(*(a.float() for a in args),
                                          act="none")
                note(("fused_conv3x3", tag), _compare(
                    got, ref, ktol, f"fused_conv3x3 {hw} {cin}->{cout} "
                    f"{dtype}"))
        case = dict(vol=(TRAIN_B, 24, TRAIN_HW[0] >> 3, TRAIN_HW[1] >> 3),
                    cin=1, cout=32, relu=False)
        args, kw = conv3d_operands(case, dtype, device, gen)
        got = fused_conv3d(*args, **kw)
        ref = fused_conv3d_plain(*(a.float() for a in args), **kw)
        note(("fused_conv3d", tag),
             _compare(got, ref, ktol, f"fused_conv3d {case} {dtype}"))
        log(f"  {len(dw_cases())} K4 cases and 7 new K1/K3 pair cases "
            f"within tolerance in {dtype}")
    return worst


def time_train_kernels(device, peaks) -> dict:
    """bf16 timings of K4 at its largest launch (2D, and the 3D form), and
    of the K1 / K3 pairs the backward adds, at the training shapes."""
    bw, flops_peak = peaks
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    rows = {}
    for key, case in (("dw_reduce", dict(hw=TRAIN_HW, cin=32, cout=32, dil=1)),
                      ("dw_reduce 3D", dict(vol=(24, TRAIN_HW[0] >> 3,
                                                 TRAIN_HW[1] >> 3),
                                            cin=32, cout=32))):
        x, g = _dw_operands(case, torch.bfloat16, device, gen)
        x_nc = x.movedim(-1, 1)  # channels-last NCHW / NCDHW views
        g_nc = g.movedim(-1, 1)
        if "vol" in case:
            fn, plain = (lambda: dw_reduce3d(x, g)), (
                lambda: dw_reduce3d_plain(x, g))
            lib = (lambda: torch.nn.grad.conv3d_weight(
                x_nc, (32, 32, 3, 3, 3), g_nc, padding=1))
            shape = f"{TRAIN_B}x{'x'.join(map(str, case['vol']))} 32->32"
            taps = 27
        else:
            fn, plain = (lambda: dw_reduce(x, g)), (
                lambda: dw_reduce_plain(x, g))
            lib = (lambda: torch.nn.grad.conv2d_weight(
                x_nc, (32, 32, 3, 3), g_nc, padding=1))
            shape = f"{TRAIN_B}x{case['hw'][0]}x{case['hw'][1]} 32->32 d1"
            taps = 9
        out = fn()
        pixels = x.numel() // 32
        rows[key] = dict(shape=shape, ms=time_ms(fn), plain_ms=time_ms(plain),
                         library_ms=time_ms(lib), bytes=_nbytes(x, g, out),
                         flops=2 * pixels * taps * 32 * 32)
    for cin, cout in ((32, 4), (1, 32)):
        args = _operands((TRAIN_B, *TRAIN_HW, cin), (3, 3, cin, cout), cout,
                         torch.bfloat16, device, gen)
        kw = dict(act="none")
        out = fused_conv3x3(*args, **kw)
        w_oihw = args[1].permute(3, 2, 0, 1).contiguous()
        x_nchw = args[0].permute(0, 3, 1, 2)
        rows[f"fused_conv3x3 {cin}->{cout}"] = dict(
            shape=f"{TRAIN_B}x{TRAIN_HW[0]}x{TRAIN_HW[1]} {cin}->{cout}",
            ms=time_ms(lambda: fused_conv3x3(*args, **kw)),
            plain_ms=time_ms(lambda: fused_conv3x3_plain(*args, **kw)),
            library_ms=time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1)),
            bytes=_nbytes(*args, out), flops=2 * out.numel() * 9 * cin)
    rows.update(time_autograd(device, gen))
    for row in rows.values():
        t_bytes = row["bytes"] / bw * 1e3
        t_ops = row["flops"] / flops_peak * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return rows


def time_autograd(device, gen) -> dict:
    """bf16 forward + backward (dx and dW) of K5 ``flat_conv3x3`` and K6
    ``flat_conv3d`` at their largest training shapes, beside the plain
    versions' autograd and cuDNN's bf16 forward + backward.  Bytes: the
    forward reads x and writes y, dx reads g and writes dx, dW reads x and g;
    operations: three convolutions' worth."""
    rows = {}
    for name, shape, taps in (("flat_conv3x3", (TRAIN_B, *TRAIN_HW), 9),
                              ("flat_conv3d", (TRAIN_B, 24, TRAIN_HW[0] >> 3,
                                               TRAIN_HW[1] >> 3), 27)):
        nd = len(shape) - 1
        x = ((torch.rand((*shape, 32), generator=gen, device=device) * 2 - 1)
             .bfloat16().requires_grad_())
        w = ((torch.rand((*([3] * nd), 32, 32), generator=gen, device=device)
              - 0.5) * 0.2).requires_grad_()
        cot = torch.rand((*shape, 32), generator=gen, device=device).bfloat16()
        one = torch.ones(32, device=device)
        zero = torch.zeros(32, device=device)
        if nd == 2:
            fn = flat_conv3x3
            plain = lambda a, b: fused_conv3x3_plain(a, b, one, zero,
                                                     act="none")
            lib = lambda a, b: F.conv2d(a.movedim(-1, 1),
                                        b.permute(3, 2, 0, 1).bfloat16(),
                                        padding=1)
        else:
            fn = flat_conv3d
            plain = lambda a, b: fused_conv3d_plain(a, b, one, zero,
                                                    relu=False)
            lib = lambda a, b: F.conv3d(a.movedim(-1, 1),
                                        b.permute(4, 3, 0, 1, 2).bfloat16(),
                                        padding=1)

        def step(f, cot_view=lambda c: c):
            y = f(x, w)
            y.backward(cot_view(cot).to(y.dtype))

        act = x.numel() * 2  # bytes of one bf16 activation
        rows[name] = dict(
            shape=f"{'x'.join(map(str, shape))} 32->32 forward + backward",
            ms=time_ms(lambda: step(fn)),
            plain_ms=time_ms(lambda: step(plain)),
            library_ms=time_ms(lambda: step(lib, lambda c: c.movedim(-1, 1))),
            bytes=6 * act + w.numel() * 4 * 2,
            flops=3 * 2 * x.numel() * taps * 32)
    return rows


def check_autograd(device) -> dict:
    """``flat_conv3x3`` / ``flat_conv3d`` backward on the kernels against
    the plain backward of the same functions (autograd through the plain
    float32 convs) on the same bf16-representable values."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    worst: dict = {}

    def rand(*shape):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1
                ).bfloat16().float()

    cases = [((2, 64, 96), 32, 32, d) for d in (1, 2, 4, 8)]
    cases += [((2, 64, 96), 4, 32, 1), ((2, 64, 96), 32, 1, 1),
              ((2, 8, 16, 24), 32, 32, None), ((2, 8, 16, 24), 32, 1, None)]
    for dtype, tol, tag in ((torch.float32, TOL_DW_F32, "f32"),
                            (torch.bfloat16, TOL_DW_BF16, "bf16")):
        for shape, cin, cout, dil in cases:
            x0, cot0 = rand(*shape, cin), rand(*shape, cout)
            w0 = (rand(*([3] * (len(shape) - 1)), cin, cout) * 0.2
                  ).bfloat16().float()
            one = torch.ones(cout, device=device)
            zero = torch.zeros(cout, device=device)
            if dil is None:
                name = "flat_conv3d"
                fn = flat_conv3d
                plain = lambda a, b: fused_conv3d_plain(a, b, one, zero,
                                                        relu=False)
            else:
                name = "flat_conv3x3"
                fn = lambda a, b, d=dil: flat_conv3x3(a, b, d)
                plain = lambda a, b, d=dil: fused_conv3x3_plain(
                    a, b, one, zero, dilation=d, act="none")
            x = x0.to(dtype).requires_grad_()
            w = w0.clone().requires_grad_()
            gx, gw = torch.autograd.grad(
                (fn(x, w).float() * cot0).sum(), (x, w))
            xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            rx, rw = torch.autograd.grad((plain(xr, wr) * cot0).sum(),
                                         (xr, wr))
            what = f"{name} {shape} {cin}->{cout} d{dil} {dtype}"
            for part, got, ref in (("dx", gx, rx), ("dW", gw, rw)):
                key = (name, part, tag)
                rel = _compare_scaled(got, ref, tol, f"{what} {part}")[1]
                worst[key] = max(worst.get(key, 0.0), rel)
    log(f"  {2 * len(cases)} backward cases within tolerance; largest error "
        f"/ scale " + json.dumps({" ".join(k): v for k, v in worst.items()}))
    return worst


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def seeded_model(device):
    """v1 from the repo config, weights and BatchNorm stats from ``SEED``."""
    config = json.loads(bench.CONFIG.read_text())["model"]
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(config, device=device, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
                n = m.running_mean.numel()
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.3)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return model


def check_model(device, hw=HW) -> dict:
    """Kernel path against the plain model; the bf16 frame is the main path
    whose launches are counted."""
    model = seeded_model(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    left, right = (torch.rand((1, *hw, 3), generator=gen, device=device) * 255
                   for _ in range(2))
    with torch.no_grad():
        plain = model(left, right)
    fast32 = make_fast_forward(model, dtype=torch.float32)(left, right)
    f32_err = []
    for i, (g, w) in enumerate(zip(fast32, plain)):
        f32_err.append(_compare(g, w, (5e-2, 1e-3), f"f32 kernel path head {i}"))
    log(f"  f32 kernel path vs plain f32: max abs err per head {f32_err}")

    fast_bf16 = make_fast_forward(model)
    if device.type == "cuda":
        torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    out = fast_bf16(left, right)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    final = out[-1]
    if final.shape != (1, *hw, 1) or not bool(torch.isfinite(final).all()):
        raise AssertionError(f"bf16 output: shape {tuple(final.shape)}")
    if float(final.max()) > 0:
        raise AssertionError("bf16 output is not negative flow")
    median = float((final - plain[-1]).abs().median())
    log(f"  bf16 kernel path vs plain f32: median |d| {median:.4f} px")
    if not median < 1.0:
        raise AssertionError(f"bf16 median error {median} px >= 1 px")
    return dict(launches=launches, f32_max_abs_err=f32_err,
                bf16_median_err_px=median)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _grad_errors(grads, want, rtol, what, floor, slack) -> tuple[float, list]:
    """Per-parameter relative L2 of ``grads`` against ``want``; raises above
    max(``rtol``, ``slack`` x the relative L2 of ``floor``, another estimate
    of the same gradient).  Returns the largest error over its limit and the
    parameters skipped for a gradient norm < 1e-3."""
    worst, skipped = 0.0, []
    for k, w in want.items():
        norm = float(w.norm())
        if norm < 1e-3:
            skipped.append(k)
            continue
        rel = float((grads[k] - w).norm()) / norm
        limit = max(rtol, slack * float((floor[k] - w).norm()) / norm)
        if not rel <= limit:
            raise AssertionError(f"{what}: gradient of {k} off by {rel:.3e} "
                                 f"relative L2 (limit {limit:.3e})")
        worst = max(worst, rel / limit)
    return worst, skipped


def _step_grads(model, img1, img2, flow, valid, loss_fn, dtype=None, *,
                plain_dtype=torch.float32):
    """Loss, gradients and new running stats of one training forward on
    ``model``'s weights: the kernel path in ``dtype``, or the plain model
    (``dtype=None``) autocast to ``plain_dtype``.  The model's running stats
    are left as they were."""
    model.zero_grad(set_to_none=True)
    before = {k: v.clone() for k, v in running_stats(model).items()}
    if dtype is None:
        with torch.autocast(img1.device.type, dtype=plain_dtype,
                            enabled=plain_dtype != torch.float32):
            preds = model(img1, img2)
        stats = {k: v.clone() for k, v in running_stats(model).items()}
        load_running_stats(model, before)
    else:
        preds, stats = fast_train_forward(model, img1, img2, dtype=dtype)
    loss = loss_fn(preds, flow, valid)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, stats


def check_train(device) -> dict:
    """The first step's kernel-path gradients against the plain path, then
    ``train()`` on the kernel path in bf16 with launches and step times."""
    cfg = load_config(bench.CONFIG)
    cfg.path = str(ROOT / "_runs" / "chip_smoke_train")  # gitignored
    cfg.train.fast_kernels = "on"
    assert tuple(cfg.data.image_size) == TRAIN_HW
    assert cfg.train.batch_size == TRAIN_B and cfg.model.mixed_precision
    t0 = time.perf_counter()
    data = SyntheticBatches(TRAIN_B, TRAIN_HW,
                            n_batches=WARMUP_STEPS + TIMED_STEPS, seed0=SEED,
                            max_disp=96.0, device=device)
    log(f"  {TRAIN_B * len(data)} synthetic scenes at {TRAIN_HW} in "
        f"{time.perf_counter() - t0:.3f} s")

    # (a), (b): the first step of train() (same seed, same first batch)
    model, *_ = create_train_state(cfg, device=device)  # train()'s seed
    batch = next(iter(data))[1:]
    loss_fn = build_loss_function({"type": cfg.train.loss.type,
                                   "parameters": cfg.train.loss.parameters})
    plain_loss, plain_g, plain_s = _step_grads(model, *batch, loss_fn)
    _, rev_g, _ = _step_grads(model, *(t.flip(0) for t in batch), loss_fn)
    k32_loss, k32_g, k32_s = _step_grads(model, *batch, loss_fn, torch.float32)
    if not abs(k32_loss - plain_loss) <= 1e-4 * abs(plain_loss):
        raise AssertionError(f"f32 kernel-path loss {k32_loss} vs plain "
                             f"{plain_loss}")
    g32_err, skipped = _grad_errors(k32_g, plain_g, GRAD_RTOL_F32,
                                    "f32 kernel path", rev_g,
                                    GRAD_F32_FLOOR_SLACK)
    stat_err = 0.0
    for k, v in plain_s.items():
        err = (k32_s[k] - v).abs()
        if bool((err > 1e-4 + 1e-4 * v.abs()).any()):
            raise AssertionError(f"BN stat {k}: max err {float(err.max())}")
        stat_err = max(stat_err, float(err.max()))
    k16_loss, k16_g, _ = _step_grads(model, *batch, loss_fn, torch.bfloat16)
    _, p16_g, _ = _step_grads(model, *batch, loss_fn,
                              plain_dtype=torch.bfloat16)
    g16_err, _ = _grad_errors(k16_g, plain_g, GRAD_RTOL_BF16,
                              "bf16 kernel path", p16_g, GRAD_BF16_FLOOR_SLACK)
    rel16 = {k: (float((k16_g[k] - w).norm()) / float(w.norm()),
                 float((p16_g[k] - w).norm()) / float(w.norm()))
             for k, w in plain_g.items() if k not in skipped}
    log(f"  first step: loss plain f32 {plain_loss:.6f}, kernel f32 "
        f"{k32_loss:.6f}, kernel bf16 {k16_loss:.6f}; worst gradient rel L2 "
        f"f32 {g32_err:.3e}, bf16 {g16_err:.3e} of its limit; BN stats max "
        f"err {stat_err:.3e}; skipped (norm < 1e-3): {skipped}")
    log("  bf16 gradient rel L2 (kernel, plain autocast) vs f32 plain, "
        "worst 8: " + json.dumps(sorted(rel16.items(),
                                        key=lambda kv: -kv[1][0])[:8]))
    log("  f32 gradient rel L2 (kernel, plain on the reversed batch) vs f32 "
        "plain, worst 4: " + json.dumps(sorted(
            ((k, (float((k32_g[k] - w).norm()) / float(w.norm()),
                  float((rev_g[k] - w).norm()) / float(w.norm())))
             for k, w in plain_g.items() if k not in skipped),
            key=lambda kv: -kv[1][0])[:4]))
    del model, plain_g, rev_g, k32_g, k16_g, p16_g

    # the training main path: train() on the kernels, counts from 0
    events, launches, losses = [], [], []

    def on_step(step, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        launches.append(dict(_build.LAUNCHES))
        losses.append(metrics["live_loss"])

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    ckpt = train(cfg, max_steps=WARMUP_STEPS + TIMED_STEPS - 1,
                 data_loader=data, device=device, on_step=on_step)
    torch.cuda.synchronize()
    run_launches = dict(_build.LAUNCHES)
    per_step = [{k: v - prev.get(k, 0) for k, v in cur.items()}
                for prev, cur in zip([{}] + launches, launches)]
    for i, counts in enumerate(per_step):
        if counts != LAUNCHES_PER_STEP:
            raise AssertionError(f"step {i} launches {counts}, expected "
                                 f"{LAUNCHES_PER_STEP}")
    loss_values = [float(v) for v in losses]
    if len(loss_values) != WARMUP_STEPS + TIMED_STEPS or not all(
            math.isfinite(v) for v in loss_values):
        raise AssertionError(f"train() losses {loss_values}")
    ms = [events[i - 1].elapsed_time(events[i])
          for i in range(WARMUP_STEPS, len(events))]
    model, *_, state = create_train_state(cfg, seed=SEED, device=device)
    restore_checkpoint(ckpt, state)
    if state.step != len(loss_values):
        raise AssertionError(f"checkpoint step {state.step}")
    shutil.rmtree(cfg.path)
    result = dict(step_ms_median=statistics.median(ms), step_ms_min=min(ms),
                  step_ms=ms, losses=loss_values, launches=run_launches,
                  launches_per_step=per_step[-1],
                  first_step=dict(loss_plain_f32=plain_loss,
                                  loss_kernel_f32=k32_loss,
                                  loss_kernel_bf16=k16_loss,
                                  grad_f32_over_limit=g32_err,
                                  grad_bf16_over_limit=g16_err,
                                  bn_stat_max_err=stat_err,
                                  skipped=skipped))
    log(f"  train(): {len(loss_values)} bf16 steps, launches per step "
        f"{per_step[-1]}, step median {result['step_ms_median']:.3f} ms, "
        f"min {result['step_ms_min']:.3f} ms; losses {loss_values}")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    peaks = next((v for k, v in PEAKS.items() if k in kind), PEAKS["H100"])
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log("set torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False")
    log(f"bounds from peaks {peaks[0]:.3g} B/s, {peaks[1]:.3g} bf16 FLOP/s")

    with Phase("build"):
        t0 = time.perf_counter()
        so = _build.build()
        _build.library()
        log(f"  built {pathlib.Path(so).name} in "
            f"{time.perf_counter() - t0:.3f} s")
    with Phase("kernels"):
        worst = check_kernels(device, conv3x3_cases(), conv3d_cases())
        rows = time_kernels(device, peaks)
    with Phase("train kernels"):
        train_worst = check_train_kernels(device)
        train_rows = time_train_kernels(device, peaks)
        log(json.dumps({"train_kernel_times": train_rows}))
    with Phase("autograd"):
        grad_worst = check_autograd(device)
    with Phase("model"):
        model_result = check_model(device)
        if model_result["launches"] != LAUNCHES_PER_FRAME:
            raise AssertionError(f"launches of one frame "
                                 f"{model_result['launches']}, expected "
                                 f"{LAUNCHES_PER_FRAME}")
    with Phase("bench"):
        _build.LAUNCHES.clear()
        record = bench.run_bench(pairs=8, seed=SEED)
        frames = record["pairs"] + record["warmup"]
        expected = {k: v * frames for k, v in LAUNCHES_PER_FRAME.items()}
        if dict(_build.LAUNCHES) != expected:
            raise AssertionError(f"bench launches {dict(_build.LAUNCHES)}, "
                                 f"expected {expected}")
        log(json.dumps(record))
    with Phase("train"):
        train_result = check_train(device)

    rows["dw_reduce"] = train_rows["dw_reduce"]
    for key in ("f32", "bf16"):  # the largest error of each kernel
        for name in ("fused_conv3x3", "fused_conv3d"):
            worst[(name, key)] = max(worst[(name, key)],
                                     train_worst[(name, key)])
        worst[("dw_reduce", key)] = train_worst[("dw_reduce", key)]
    dw_over_scale = {key: train_worst[("dw_reduce", key, "over scale")]
                     for key in ("f32", "bf16")}
    kernels = []
    for name, row in rows.items():
        by_path = {"infer_frame": model_result["launches"].get(name, 0),
                   "train_run": train_result["launches"].get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            # the count of the main path the kernel carries: the training
            # run (train() over all its steps) where it runs there, else
            # the inference frame
            "launches": by_path["train_run"] or by_path["infer_frame"],
            "launches_by_path": by_path,
            "launches_per_train_step":
                train_result["launches_per_step"].get(name, 0),
            "max_abs_err": worst[(name, "bf16")],
            "max_abs_err_f32": worst[(name, "f32")],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
        })
        if name == "dw_reduce":
            kernels[-1]["max_err_over_scale"] = dw_over_scale
            kernels[-1]["3d"] = train_rows["dw_reduce 3D"]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"frame_latency_ms": record["latency_ms"],
                    "fps": record["value"],
                    "bf16_median_err_px": model_result["bf16_median_err_px"],
                    "train_step_ms": {"median": train_result["step_ms_median"],
                                      "min": train_result["step_ms_min"]},
                    "train": train_result,
                    "autograd_err": {" ".join(k): v
                                     for k, v in grad_worst.items()},
                    "nvidia_smi": smi}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
