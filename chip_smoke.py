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
3. model: v1 from ``configure/stereo_net_config.json`` with seeded weights
   and BatchNorm stats; the float32 kernel path against the plain float32
   model at 1280x720, the bf16 kernel path (the main path) with launch
   counts, then 8 stereo pairs through ``realtime_stereo_matcher_tpu_torch.bench``.
4. report: one ``{"kernels": [...]}`` line, one latency line, the
   ``nvidia-smi`` name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no "ok".
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from realtime_stereo_matcher_tpu_torch import bench
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
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.fast_infer import make_fast_forward

SEED = 0
HW = (720, 1280)
# float32: the kernel and the plain version (cuDNN in full float32, TF32
# off) sum the same products in another order
TOL_F32 = (1e-3, 1e-3)  # (atol, rtol)
# bfloat16: the kernel rounds its output to bf16 after the activation, and
# again after the residual (<= 2^-9 relative each); the reference is the
# plain version in float32 on the same bf16-rounded inputs, unrounded
TOL_BF16 = (2e-2, 1e-2)
# launches of one 720p frame on the main path
LAUNCHES_PER_FRAME = {"fused_conv3x3": 56, "fused_conv3x3_s2": 6,
                      "fused_conv3d": 5}
REPLACES = {
    "fused_conv3x3": "realtime_stereo_matcher_tpu/kernels/conv3x3.py:369",
    "fused_conv3x3_s2": "realtime_stereo_matcher_tpu/kernels/conv3x3.py:613",
    "fused_conv3d": "realtime_stereo_matcher_tpu/kernels/cost_filter3d.py:213",
}
SOURCES = {
    "fused_conv3x3": "realtime_stereo_matcher_tpu_torch/csrc/conv3x3.cu",
    "fused_conv3x3_s2": "realtime_stereo_matcher_tpu_torch/csrc/conv3x3.cu",
    "fused_conv3d": "realtime_stereo_matcher_tpu_torch/csrc/conv3d.cu",
}
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

    kernels = []
    for name, row in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": model_result["launches"][name],
            "max_abs_err": worst[(name, "bf16")],
            "max_abs_err_f32": worst[(name, "f32")],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"frame_latency_ms": record["latency_ms"],
                    "fps": record["value"],
                    "bf16_median_err_px": model_result["bf16_median_err_px"],
                    "nvidia_smi": smi}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
