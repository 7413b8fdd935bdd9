"""Build and bind the CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface, which is loaded with ``ctypes``.  No PyTorch header is compiled,
so the build takes seconds.  The library is
named by a hash of the sources and flags and kept in ``_build/`` inside the
package (ignored by git); a source change builds a new one.  Nothing is
built or loaded at import: the first kernel launch does it.

Every kernel wrapper adds one to ``LAUNCHES[<kernel name>]`` where it
launches its kernel, so a run can show which kernels carried it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# launches per kernel name; reset with LAUNCHES.clear()
LAUNCHES: collections.Counter = collections.Counter()

# dtype codes of the C interface (csrc/conv_common.cuh, enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, scale, bias, res, out, dtype, n, h, w, cin, cout, ho, wo,
    # stride, dilation, act, alpha, device, stream
    "rsm_conv3x3": [_P] * 6 + [_I] * 11 + [ctypes.c_float, _I, _P],
    # x, w, scale, bias, out, dtype, n, d, h, w, cin, cout, act, device, stream
    "rsm_conv3d": [_P] * 5 + [_I] * 9 + [_P],
    # x, g, work, out, dtype, n, d, h, w, cin, cout, kd, dil, device, stream
    "rsm_dw_reduce": [_P] * 4 + [_I] * 10 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librsm_kernels-{h.hexdigest()[:16]}.so"


def _raise_nvcc(cmd, rc, out, err):
    raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}\n{err}")


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` (one nvcc per file, all in parallel) and link
    the library, unless it is already built."""
    so = library_path()
    if so.exists():
        return so
    tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    try:
        nvcc = _nvcc()
        for src in sorted(CSRC.glob("*.cu")):
            objs.append(tmp / f"{src.stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(objs[-1])]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for cmd, proc in procs:
            out, err = proc.communicate(timeout=900)
            if proc.returncode:
                _raise_nvcc(cmd, proc.returncode, out, err)
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp / so.name), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode:
            _raise_nvcc(cmd, proc.returncode, proc.stdout, proc.stderr)
        os.replace(tmp / so.name, so)
    finally:
        for _, proc in procs:  # no compiler outlives a failed build
            proc.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rsm_error_string.argtypes = [ctypes.c_int]
    lib.rsm_error_string.restype = ctypes.c_char_p
    # n, d, h, w, cin, cout, kd, dil -> floats of workspace, -1 if unsupported
    lib.rsm_dw_workspace.argtypes = [_I] * 8
    lib.rsm_dw_workspace.restype = ctypes.c_longlong
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().rsm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, *, shape, dtype, device) -> None:
    """Raise unless ``t`` has this shape, dtype and device, is contiguous and
    16-byte aligned, and fits the 32-bit indexing of the kernels."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {t.numel()} elements exceed 32-bit indexing")
