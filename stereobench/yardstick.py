"""The benchmark's frozen arithmetic: the card's peaks, the least time of a
piece of work, percentiles, the union of kernel intervals, the grouping of
kernel names and the work of a model counted from its plain reference.

Later changes to the program do not move these numbers: the peaks and the
bound are a copy of ``chip_smoke.py``'s ``PEAKS`` / ``bound`` and the
grouping a copy of ``realtime_stereo_matcher_tpu_torch/frame_profile.py``'s
``kernel_group`` patterns, both at commit 5ab33e5.  The work of a frame is
counted on the benchmark's own reference (``stereobench/reference/``) on
the meta device, so it reads the same whatever implements it.
"""

from __future__ import annotations

import math
import re

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

# memory rate (bytes/s) and dense bf16 tensor-core rate (FLOP/s) of one
# NVIDIA H100 SXM, from NVIDIA's data sheet (700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 989e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations over
    the bf16 rate and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linear between the two
    nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_intervals(intervals):
    """Sorted, merged (start, end) intervals covering the same points."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def covered(intervals, lo: float, hi: float) -> float:
    """The length of ``[lo, hi]`` that the union of ``intervals`` covers."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in union_intervals(intervals))


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for s, e in union_intervals(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


# ---- kernel names (frozen copy of frame_profile.kernel_group) ----

_CONV = re.compile(r"conv_kernel<([^,]+),\s*(\d+),\s*(\d+),\s*(\d+),"
                   r"\s*(\d+)(?:,\s*(\d+))?>")
_CONV_TC = re.compile(r"conv_tc_kernel<\s*(?:\(int\)\s*)?(\d+)")
_DW = re.compile(r"dw_partial_kernel<([^,]+),\s*(\d+),\s*(\d+),\s*(\d+)>")
_INT = r"\s*(?:\(int\)\s*)?(\d+)"
_DW_TC = re.compile(rf"dw_tc_kernel<{_INT}(?:,{_INT},{_INT})?")
_S2_TC = re.compile(rf"conv_s2_tc_kernel<{_INT}")
_NIN_TC = re.compile(rf"conv_nin_tc_kernel<{_INT}")
_NOUT_TC = re.compile(rf"conv_nout_tc_kernel<{_INT}")
_S2_NIN_TC = re.compile(rf"conv_s2_nin_tc_kernel<{_INT}")
_K3_NARROW_TC = re.compile(r"conv3d_n(in|out)_tc_kernel\b")
# the port's own kernels live in namespace rsm::
_PORT = re.compile(r"\brsm::")
# library kernels that compute convolutions or matrix products (cuDNN,
# cuBLAS, CUTLASS): implicit GEMMs, GEMMs, Winograd and FFT convolutions
_LIBRARY_CONV = re.compile(
    r"xmma|gemm|cutlass|cudnn|implicit_convolve|winograd|fft2d|"
    r"conv2d_grouped|convolve|dgrad|wgrad|fprop", re.IGNORECASE)


def kernel_group(name: str) -> str:
    """A device kernel's group: the port's kernels by (kernel, C_in, C_out),
    anything else as ``plain: <name up to its template arguments>``."""
    m = _CONV_TC.search(name)
    if m:
        kernel = "fused_conv3d" if m.group(1) == "3" else "fused_conv3x3"
        return f"{kernel} 32->32"
    m = _S2_NIN_TC.search(name)
    if m:
        return f"fused_conv3x3_s2 {m.group(1)}->32"
    m = _K3_NARROW_TC.search(name)
    if m:
        return "fused_conv3d " + ("1->32" if m.group(1) == "in" else "32->1")
    m = _S2_TC.search(name)
    if m:
        kernel = "fused_conv4x4_s2" if m.group(1) == "4" else "fused_conv3x3_s2"
        return f"{kernel} 32->32"
    m = _DW_TC.search(name)
    if m:
        kd, ci, co = m.group(1), m.group(2) or "32", m.group(3) or "32"
        return f"dw_reduce{' 3D' if kd == '3' else ''} {ci}->{co}"
    m = _NIN_TC.search(name)
    if m:
        return f"fused_conv3x3 {m.group(1)}->32"
    m = _NOUT_TC.search(name)
    if m:
        return f"fused_conv3x3 32->{m.group(1)}"
    m = _CONV.search(name)
    if m:
        _, ci, co, s, kd, k = m.groups()
        kernel = ("fused_conv3d" if kd == "3" else
                  "fused_conv4x4_s2" if k == "4" else
                  "fused_conv3x3_s2" if s == "2" else "fused_conv3x3")
        return f"{kernel} {ci}->{co}"
    m = _DW.search(name)
    if m:
        _, kd, ci, co = m.groups()
        return f"dw_reduce{' 3D' if kd == '3' else ''} {ci}->{co}"
    if "dw_sum_kernel" in name:
        return "dw_reduce partial sums"
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return "plain: " + name.split("<")[0].split("(")[0][:80].strip()


def is_port_kernel(name: str) -> bool:
    """A kernel of the port's own library (namespace ``rsm::``)."""
    return bool(_PORT.search(name)) or not kernel_group(name).startswith("plain:")


def is_conv_kernel(name: str) -> bool:
    """A kernel that computes a convolution: the port's own, or a cuDNN /
    cuBLAS / CUTLASS convolution or matrix product."""
    return is_port_kernel(name) or bool(_LIBRARY_CONV.search(name))


# ---- work counted on the reference ----

_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)


def conv_work(model: nn.Module, inputs, *, bytes_per_element: int = 2,
              backward: bool = False):
    """(flops, least seconds) of every convolution of ``model(*inputs)``,
    run on the meta device.

    A convolution's operations are 2 x its multiply-adds; its bytes are its
    input and weight read once and its output written once, at
    ``bytes_per_element``.  With ``backward`` each convolution also counts
    its weight gradient (input and output gradient read, the weight
    gradient written) and, where its input needs one, its input gradient
    (the output gradient and the weight read, the input gradient written),
    each with the forward's operations."""
    flops, seconds = 0.0, 0.0

    def hook(mod, args, out):
        nonlocal flops, seconds
        x = args[0]
        w = mod.weight
        if isinstance(mod, nn.ConvTranspose2d):
            macs = x.numel() * w.shape[1] * math.prod(w.shape[2:])
        else:
            macs = out.numel() * math.prod(w.shape[1:])
        f = 2.0 * macs
        nx, nw, ny = x.numel(), w.numel(), out.numel()
        parts = [(f, nx + nw + ny)]
        if backward:
            parts.append((f, nx + ny + nw))          # weight gradient
            if x.requires_grad:                      # input gradient
                parts.append((f, ny + nw + nx))
        for pf, pn in parts:
            flops += pf
            seconds += least_seconds(pf, pn * bytes_per_element)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, _CONVS)]
    try:
        with torch.set_grad_enabled(backward):
            model(*inputs)
    finally:
        for h in handles:
            h.remove()
    return flops, seconds


def model_flops_train(model: nn.Module, inputs) -> float:
    """The FLOPs of a forward of ``model(*inputs)`` and the backward of the
    sum of its outputs, as ``FlopCounterMode`` counts them, on the meta
    device."""
    counter = FlopCounterMode(display=False)
    with counter:
        outs = model(*inputs)
        sum(o.sum() for o in outs).backward()
    return float(counter.get_total_flops())


def model_flops(model: nn.Module, inputs) -> float:
    """The FLOPs of ``model(*inputs)`` as ``FlopCounterMode`` counts them
    (matrix products and convolutions, 2 x multiply-adds), on the meta
    device."""
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(*inputs)
    return float(counter.get_total_flops())
