"""PNG files in numpy and ``zlib``, with no Pillow or cv2.

The card's machine has neither library, so the port reads and writes PNGs
itself (``infer``, ``data/frame_io.py``):

* :func:`read_png` -- non-interlaced PNGs of 8-bit grey, grey + alpha, RGB,
  RGBA and palette indices, and 16-bit grey and RGB, every row filter
  (None, Sub, Up, Average, Paeth), into the array Pillow's
  ``np.array(Image.open(...))`` gives: uint8 (H, W), (H, W, 2), (H, W, 3)
  or (H, W, 4), the palette's indices as uint8 (H, W), uint16 (H, W) for
  16-bit grey.  16-bit RGB (KITTI's flow files) comes back as its uint16
  (H, W, 3) samples in RGB order, the values cv2 reads (in BGR order);
  Pillow keeps only their high bytes.  Any other kind (interlaced, fewer
  than 8 bits, 16-bit grey + alpha or RGBA) raises :class:`UnsupportedPNG`;
* :func:`write_png` -- uint8 grey / RGB / RGBA and uint16 grey / RGB
  arrays, rows unfiltered, zlib level 6.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class UnsupportedPNG(ValueError):
    """A PNG of a kind :func:`read_png` does not decode."""


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file without IEND")


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines' bytes after undoing each row's filter."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(
        h, stride + 1)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: running sums of each byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8
                            ).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:  # Average
                    pred = (a + b) >> 1
                else:  # Paeth
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} unknown")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path) -> np.ndarray:
    """Decode the PNG at ``path`` (see the module docstring for the kinds
    and the arrays)."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if (colour not in _CHANNELS or interlace
            or depth not in (8, 16) or (depth == 16 and colour not in (0, 2))):
        raise UnsupportedPNG(f"{path}: colour type {colour}, {depth} bits, "
                             f"interlace {interlace}")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        rows = rows.view(">u2").astype(np.uint16)
    return rows.reshape(h, w, channels) if channels > 1 else rows.reshape(h, w)


def write_png(path, image: np.ndarray) -> None:
    """Write a uint8 (H, W), (H, W, 3) or (H, W, 4) array (grey, RGB, RGBA)
    or a uint16 (H, W) or (H, W, 3) array (16-bit grey, RGB) as a PNG at
    ``path``."""
    a = np.asarray(image)
    if a.dtype == np.uint16 and (a.ndim == 2 or a.ndim == 3
                                 and a.shape[2] == 3):
        depth, colour = 16, 0 if a.ndim == 2 else 2
        rows = a.astype(">u2").view(np.uint8).reshape(a.shape[0], -1)
    elif a.dtype == np.uint8 and a.ndim == 2:
        depth, colour, rows = 8, 0, a
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] in (3, 4):
        depth, colour = 8, 2 if a.shape[2] == 3 else 6
        rows = a.reshape(a.shape[0], -1)
    else:
        raise ValueError(f"write_png takes uint8 grey / RGB / RGBA or uint16 "
                         f"grey / RGB, not {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(rows).reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))
