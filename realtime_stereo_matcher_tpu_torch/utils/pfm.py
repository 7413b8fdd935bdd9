"""PFM (portable float map) IO (a copy of the JAX package's framework-free
``realtime_stereo_matcher_tpu/utils/pfm.py``; the port imports nothing of
that package).

Covers both reference copies (dataset/frame_utils.py:34-69 ``readPFM`` and
tools/pfm_file_io.py:6-77): header parse, endianness via the sign of the
scale line, and the bottom-up row order (vertical flip on read/write).
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np


def read_pfm(path) -> tuple[np.ndarray, float]:
    """Read a PFM file -> (H, W) or (H, W, 3) float array + scale."""
    with open(path, "rb") as fp:
        header = fp.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"Not a PFM file: {path}")

        dims = fp.readline().decode("ascii")
        m = re.search(r"(\d+)\s(\d+)", dims)
        if not m:
            raise ValueError(f"Malformed PFM header: {path}")
        width, height = map(int, m.groups())

        scale = float(fp.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        shape = (height, width, 3) if color else (height, width)
        data = np.fromfile(fp, endian + "f").reshape(shape)
    return np.flipud(data).copy(), scale


def write_pfm(path, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 array as PFM (grayscale (H, W)/(H, W, 1) or color)."""
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError("Image dtype must be float32.")
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2:
        color = False
    else:
        raise ValueError("Image must have HxW, HxWx1 or HxWx3 dims.")

    with open(path, "wb") as fp:
        fp.write(b"PF\n" if color else b"Pf\n")
        fp.write(b"%d %d\n" % (image.shape[1], image.shape[0]))
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        fp.write(b"%f\n" % scale)
        np.flipud(image).astype(np.float32).tofile(fp)
