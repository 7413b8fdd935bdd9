"""SGBM classical baseline: ctypes wrapper over the native C++ matcher (a
copy of ``realtime_stereo_matcher_tpu/classical/sgbm.py``).

Drop-in replacement for the reference's OpenCV wrapper
(reference model/opencv_sgbm_module.py:8-75) with the same parameter surface,
grayscale conversion quirk, /16 fixed-point decode, and output interface
(a list with one (B, H, W, 1) *negative* disparity array) -- but backed by
this framework's own native SGBM (native/sgbm.cpp) instead of OpenCV, and
multithreaded over the batch.

It is the framework's deterministic parity anchor: CPU-runnable, no trained
weights, same ``model(left, right) -> [disp]`` call shape as the neural zoo.
It runs on the host: the inputs may be numpy arrays or torch tensors (on any
device) and the output is numpy.  The port keeps its own copy of the C++
source (``native/sgbm.cpp``), built with g++ at first use
(``utils/native_build.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from realtime_stereo_matcher_tpu_torch.utils.native_build import build_native

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build_native("sgbm.cpp")))
                lib.sgbm_compute.restype = ctypes.c_int
                lib.sgbm_compute.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_uint8),
                    *([ctypes.c_int] * 13),
                    ctypes.POINTER(ctypes.c_int16),
                ]
                _lib = lib
    return _lib


def bgr2gray_like_reference(img: np.ndarray) -> np.ndarray:
    """The reference feeds RGB tensors through cv.COLOR_BGR2GRAY
    (model/opencv_sgbm_module.py:60-61), i.e. Y = .114*ch0 + .587*ch1 +
    .299*ch2 on RGB data, then truncates to uint8.  Reproduced verbatim."""
    if img.ndim == 2:
        return img.astype(np.uint8)
    y = 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
    return y.astype(np.uint8)


def sgbm_compute(
    left_gray: np.ndarray,
    right_gray: np.ndarray,
    *,
    min_disp: int = 0,
    num_of_disps: int = 128,
    block_size: int = 5,
    p1: int = 256,
    p2: int = 240,
    pre_filter_cap: int = 63,
    uniqueness_ratio: int = 15,
    speckle_win_size: int = 164,
    speckle_range: int = 5,
    disp12_max_diff: int = 1,
    mode: int = 1,
) -> np.ndarray:
    """Run native SGBM on one uint8 grayscale pair.

    Returns float32 (H, W) disparity (OpenCV semantics: fixed-point / 16,
    invalid pixels = min_disp - 1).
    """
    lib = _load()
    h, w = left_gray.shape
    lg = np.ascontiguousarray(left_gray, dtype=np.uint8)
    rg = np.ascontiguousarray(right_gray, dtype=np.uint8)
    out = np.empty((h, w), dtype=np.int16)
    rc = lib.sgbm_compute(
        lg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, min_disp, num_of_disps, block_size, p1, p2, pre_filter_cap,
        uniqueness_ratio, speckle_win_size, speckle_range, disp12_max_diff,
        mode,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    if rc != 0:
        raise RuntimeError(f"sgbm_compute failed with code {rc}")
    return out.astype(np.float32) / 16.0


def _host(img) -> np.ndarray:
    """An image batch as a host numpy array (a torch tensor is copied off
    its device)."""
    if hasattr(img, "detach"):
        return img.detach().cpu().numpy()
    return np.asarray(img)


@dataclasses.dataclass
class SGBMModule:
    """Reference-compatible SGBM module (model/opencv_sgbm_module.py:8-75)."""

    block_size: int = 5
    pre_filter_cap: int = 63
    min_disp: int = 0
    num_of_disps: int = 128
    speckle_range: int = 5
    speckle_win_size: int = 164
    disp12_max_diff: int = 1
    uniqueness_ratio: int = 15
    mode: int = 1
    p1: int = 256
    p2: int = 240

    def __call__(self, l_img, r_img):
        """(B, H, W, C) uint8-range arrays -> [(B, H, W, 1) float32 negative
        disparity].  Batch items run on a thread pool (the C++ core releases
        no GIL-bound Python state)."""
        l_img, r_img = (_host(a) for a in (l_img, r_img))
        n = l_img.shape[0]

        def one(i):
            lg = bgr2gray_like_reference(l_img[i])
            rg = bgr2gray_like_reference(r_img[i])
            d = sgbm_compute(
                lg, rg,
                min_disp=self.min_disp, num_of_disps=self.num_of_disps,
                block_size=self.block_size, p1=self.p1, p2=self.p2,
                pre_filter_cap=self.pre_filter_cap,
                uniqueness_ratio=self.uniqueness_ratio,
                speckle_win_size=self.speckle_win_size,
                speckle_range=self.speckle_range,
                disp12_max_diff=self.disp12_max_diff, mode=self.mode,
            )
            return -1.0 * d

        if n == 1:
            disps = [one(0)]
        else:
            with ThreadPoolExecutor(max_workers=min(n, 8)) as pool:
                disps = list(pool.map(one, range(n)))
        return [np.stack(disps, axis=0)[..., None]]
