"""Dataset frame readers and flow writers (a copy of the JAX package's
framework-free ``realtime_stereo_matcher_tpu/data/frame_io.py``; reference
dataset/frame_utils.py).

Host-side IO stays numpy, CPU preprocessing feeding the card.  PNGs are
decoded by the port's own reader (``utils/png.py``, numpy and ``zlib``: the
arrays Pillow gives); Pillow is imported only for other image formats (JPG,
PPM) and PNG kinds that reader does not take, so importing this module,
the PNG, PFM and ``.flo`` readers and the synthetic scenes need no Pillow.
Every reader mirrors the reference's decoding semantics:

* ``.flo`` Middlebury flow, read and written (:13-32)
* PFM via utils/pfm.py (:34-69)
* KITTI 16-bit PNG disparity / 256 with disp > 0 validity (:124-127)
* Sintel RGB-coded disparity + occlusion mask (:130-136)
* FallingThings depth -> disparity via fx * 6 cm baseline (:139-146)
* TartanAir npy depth -> disparity = 80 / depth (:149-153)
* Middlebury PFM + nocc mask (:156-168)
* KITTI flow, 16-bit RGB PNGs of ``64 * uv + 2**15`` and a valid channel,
  read (:117-122) and written by ``utils/png.py``: no Pillow
  (which keeps only the high byte of a 16-bit RGB sample, and whose
  version 12 refuses the JAX package's ``write_flow_kitti``)
* ``read_gen`` extension dispatch (:177-191)
"""

from __future__ import annotations

import json
import os
from os.path import basename, exists, splitext

import numpy as np

from realtime_stereo_matcher_tpu_torch.utils.pfm import read_pfm
from realtime_stereo_matcher_tpu_torch.utils.png import (
    UnsupportedPNG,
    read_png,
    write_png,
)

TAG_CHAR = np.array([202021.25], np.float32)


def _open_image(path):
    """An image file as an array-like: a PNG decoded by ``utils/png.py``
    (Pillow's arrays), anything else (or a PNG kind it does not take) by
    Pillow."""
    if str(path).lower().endswith(".png"):
        try:
            return read_png(path)
        except UnsupportedPNG:
            pass
    from PIL import Image

    return Image.open(path)


def read_image(path) -> np.ndarray:
    """An image file as the array Pillow's ``np.array(Image.open(path))``
    gives (PNGs without Pillow)."""
    return np.asarray(_open_image(path))


def read_flow(path) -> np.ndarray | None:
    """Middlebury .flo reader (little-endian)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic != 202021.25:
            return None
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return np.resize(data, (h, w, 2))


def write_flow(path, uv: np.ndarray) -> None:
    """Middlebury .flo writer: the tag, width and height, then (H, W, 2)
    float32 flow, little-endian."""
    assert uv.ndim == 3 and uv.shape[2] == 2
    h, w = uv.shape[:2]
    with open(path, "wb") as f:
        TAG_CHAR.tofile(f)
        np.array(w, np.int32).tofile(f)
        np.array(h, np.int32).tofile(f)
        uv.astype(np.float32).tofile(f)


def _read_png_16bit(path) -> np.ndarray:
    """16-bit grayscale PNG (KITTI disparity encoding)."""
    img = _open_image(path)
    return np.asarray(img, dtype=np.float32)


def read_disp_kitti(path):
    """KITTI: uint16 png / 256, valid where > 0 (reference :124-127)."""
    disp = _read_png_16bit(path) / 256.0
    return disp, disp > 0.0


def read_disp_sintel(path):
    """Sintel RGB-coded disparity + occlusion mask (reference :130-136)."""
    a = np.array(_open_image(path))
    d_r, d_g, d_b = np.split(a, 3, axis=2)
    disp = (d_r * 4 + d_g / (2 ** 6) + d_b / (2 ** 14))[..., 0]
    mask = np.array(_open_image(path.replace("disparities", "occlusions")))
    valid = (mask == 0) & (disp > 0)
    return disp, valid


def read_disp_falling_things(path):
    """FallingThings: depth png + camera fx -> disparity (reference :139-146)."""
    a = np.array(_open_image(path))
    cam_file = os.path.join(os.path.dirname(path), "_camera_settings.json")
    with open(cam_file, "r") as f:
        intrinsics = json.load(f)
    fx = intrinsics["camera_settings"][0]["intrinsic_settings"]["fx"]
    disp = (fx * 6.0 * 100) / a.astype(np.float32)
    return disp, disp > 0


def read_disp_tartan_air(path):
    """TartanAir: npy depth -> disparity = 80 / depth (reference :149-153)."""
    depth = np.load(path)
    disp = 80.0 / depth
    return disp, disp > 0


def read_disp_middlebury(path):
    """MiddEval3 disp0GT.pfm + mask0nocc.png, or 2014 disp0.pfm
    (reference :156-168)."""
    name = basename(path)
    if name == "disp0GT.pfm":
        disp, _ = read_pfm(path)
        disp = disp.astype(np.float32)
        assert disp.ndim == 2
        nocc = path.replace("disp0GT.pfm", "mask0nocc.png")
        assert exists(nocc)
        mask = np.array(_open_image(nocc)) == 255
        assert np.any(mask)
        return disp, mask
    if name == "disp0.pfm":
        disp, _ = read_pfm(path)
        disp = disp.astype(np.float32)
        return disp, disp < 1e3
    raise ValueError(f"unknown middlebury disparity file: {path}")


def read_flow_kitti(path):
    """KITTI flow PNG -> (flow (H, W, 2) = (uv - 2**15) / 64, valid (H, W))
    in float32 (reference :117-122)."""
    raw = np.asarray(_open_image(path), dtype=np.float32)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    return (flow - 2 ** 15) / 64.0, valid


def write_flow_kitti(path, uv) -> None:
    """(H, W, 2) flow -> KITTI flow PNG: ``64 * uv + 2**15`` and a valid
    channel of ones, as uint16 RGB (the JAX package's ``write_flow_kitti``,
    which Pillow 12 refuses: it takes no uint16 RGB array)."""
    uv = 64.0 * np.asarray(uv) + 2 ** 15
    valid = np.ones([uv.shape[0], uv.shape[1], 1])
    write_png(path, np.concatenate([uv, valid], axis=-1).astype(np.uint16))


def read_gen(path, pil: bool = False):
    """Extension-dispatch generic reader (reference :177-191)."""
    ext = splitext(path)[-1]
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        return _open_image(path)
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flow(path).astype(np.float32)
    if ext == ".pfm":
        flow, _ = read_pfm(path)
        flow = flow.astype(np.float32)
        if flow.ndim == 2:
            return flow
        return flow[:, :, :-1]
    return []
