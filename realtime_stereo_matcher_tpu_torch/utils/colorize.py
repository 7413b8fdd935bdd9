"""Disparity colorization (a copy of the JAX package's framework-free
``realtime_stereo_matcher_tpu/utils/colorize.py``; reference
tools/colorize.py:6-21).

Jet colormap implemented directly (no matplotlib dependency in the serving
path): values normalized to [min_val, max_val], mapped through the classic
jet ramp, returned as BGR uint8 with invalid (< 1e-9) pixels zeroed --
matching the reference's output encoding for written PNGs.
"""

from __future__ import annotations

import numpy as np


def _jet(x: np.ndarray) -> np.ndarray:
    """Classic jet colormap on x in [0, 1] -> RGB float in [0, 1]."""
    x = np.clip(x, 0.0, 1.0)

    def ramp(v):
        return np.clip(np.minimum(v * 4.0 + 0.5, -v * 4.0 + 4.5), 0.0, 1.0)

    r = ramp(x - 0.5)
    g = ramp(x - 0.25)
    b = ramp(x)
    return np.stack([r, g, b], axis=-1)


def colorize_2d_matrix(mat: np.ndarray, min_val: float = 10.0,
                       max_val: float = 100.0) -> np.ndarray:
    """(H, W) float -> (H, W, 3) BGR uint8; invalid (< 1e-9) pixels black."""
    mat = np.asarray(mat, dtype=np.float32)
    invalid = mat < 1e-9
    norm = (mat - min_val) / max(max_val - min_val, 1e-12)
    rgb = (_jet(norm) * 255.0).astype(np.uint8)
    rgb[invalid] = 0
    return rgb[:, :, ::-1]
