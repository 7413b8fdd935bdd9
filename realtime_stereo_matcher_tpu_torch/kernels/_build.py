"""Build and bind the CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` files are compiled by one ``nvcc`` call into one shared
library with a plain C interface, which is loaded with ``ctypes``.  No
PyTorch header is compiled, so the build takes seconds.  The library is
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
              "-shared", "-Xcompiler", "-fPIC")

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librsm_kernels-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` into the library unless it is already built."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
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
