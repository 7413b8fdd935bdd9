"""The port's PNG codec (``utils/png.py``) against Pillow, and the frame
readers that use it against the JAX package's (Pillow's decodes).

* :func:`read_png` gives Pillow's ``np.array(Image.open(...))`` bit for
  bit (values, dtype, shape) on 8-bit grey, grey + alpha, RGB, RGBA and
  palette PNGs and 16-bit grey PNGs written by Pillow (compression levels
  0, 1, 6, 9 and ``optimize``) and by cv2 (levels 0, 3, 9); the files use
  every row filter (None, Sub, Up, Average, Paeth);
* Pillow decodes :func:`write_png`'s files to the written arrays;
* interlaced and 1-bit files raise ``UnsupportedPNG``, and the frame
  opener hands them to Pillow, so its decodes stay Pillow's;
* ``data/frame_io.py``'s readers (``read_image``, ``read_gen``, KITTI 16-bit
  disparity, Sintel disparity and occlusion) equal the JAX package's.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from realtime_stereo_matcher_tpu.data import frame_io as jax_frame_io
from realtime_stereo_matcher_tpu_torch.data import frame_io
from realtime_stereo_matcher_tpu_torch.utils.png import (
    UnsupportedPNG,
    read_png,
    write_png,
)

SHAPE = (37, 53)
KINDS = {"L": (SHAPE, np.uint8), "LA": ((*SHAPE, 2), np.uint8),
         "RGB": ((*SHAPE, 3), np.uint8), "RGBA": ((*SHAPE, 4), np.uint8),
         "P": (SHAPE, np.uint8), "I;16": (SHAPE, np.uint16)}
PIL_LEVELS = [0, 1, 6, 9, "optimize"]
CV2_LEVELS = [0, 3, 9]


def image(kind: str, seed: int = 0) -> np.ndarray:
    """A smooth seeded image of ``kind`` (smooth, so that the encoders pick
    varied row filters)."""
    shape, dtype = KINDS[kind]
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape)
    for _ in range(3):
        x = (x + np.roll(x, 1, 0) + np.roll(x, 1, 1)) / 3
    x = (x - x.min()) / (x.max() - x.min())
    top = 65535 if dtype == np.uint16 else (15 if kind == "P" else 255)
    return (x * top).astype(dtype)


def pil_image(kind: str, a: np.ndarray) -> Image.Image:
    if kind == "P":
        img = Image.fromarray(a, "L").convert("P")
        img.putpalette([v for i in range(256) for v in (i, 255 - i, i // 2)])
        return img
    if kind == "I;16":
        return Image.fromarray(a)
    return Image.fromarray(a, kind)


def write_pil(path, kind, level) -> None:
    img = pil_image(kind, image(kind))
    if level == "optimize":
        img.save(path, optimize=True)
    else:
        img.save(path, compress_level=level)


def filters_of(path) -> set:
    """The row filter types used in a PNG file."""
    data = open(path, "rb").read()
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, colour = header[:4]
    stride = w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour] * depth // 8
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * (stride + 1)] for y in range(h)}


def _assert_pillow_decode(path):
    got, want = read_png(path), np.array(Image.open(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("level", PIL_LEVELS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_reader_is_pillow_on_pillow_files(tmp_path, kind, level):
    path = tmp_path / "a.png"
    write_pil(path, kind, level)
    _assert_pillow_decode(path)


@pytest.mark.parametrize("level", CV2_LEVELS)
@pytest.mark.parametrize("kind", ["L", "RGB", "RGBA", "I;16"])
def test_reader_is_pillow_on_cv2_files(tmp_path, kind, level):
    cv2 = pytest.importorskip("cv2")
    a = image(kind)
    bgr = {"RGB": [2, 1, 0], "RGBA": [2, 1, 0, 3]}.get(kind)
    path = tmp_path / "a.png"
    assert cv2.imwrite(str(path), a if bgr is None else a[..., bgr],
                       [cv2.IMWRITE_PNG_COMPRESSION, level])
    _assert_pillow_decode(path)


def test_the_files_use_every_row_filter(tmp_path):
    cv2 = pytest.importorskip("cv2")
    used = set()
    for kind in KINDS:
        for level in PIL_LEVELS:
            path = tmp_path / f"{kind.replace(';', '')}_{level}.png"
            write_pil(path, kind, level)
            used |= filters_of(path)
        for level in CV2_LEVELS:
            if kind in ("L", "I;16"):
                path = tmp_path / f"cv2_{kind.replace(';', '')}_{level}.png"
                cv2.imwrite(str(path), image(kind),
                            [cv2.IMWRITE_PNG_COMPRESSION, level])
                used |= filters_of(path)
    assert used == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("kind", ["L", "RGB", "RGBA", "I;16"])
def test_pillow_reads_the_writers_files(tmp_path, kind):
    a = image(kind, seed=1)
    path = tmp_path / "w.png"
    write_png(path, a)
    got = np.array(Image.open(path))
    assert got.dtype == a.dtype and np.array_equal(got, a)
    assert np.array_equal(read_png(path), a)


def test_writer_refuses_other_arrays(tmp_path):
    with pytest.raises(ValueError, match="write_png takes"):
        write_png(tmp_path / "x.png", np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError, match="write_png takes"):
        write_png(tmp_path / "x.png", np.zeros((4, 4), np.float32))


def test_other_kinds_raise_and_the_opener_takes_pillow(tmp_path):
    """A 1-bit PNG (Pillow's mode "1") raises, and the frame opener decodes
    it with Pillow; an interlaced one (its IHDR flag set) raises."""
    path = tmp_path / "o.png"
    Image.fromarray(image("L") > 128).save(path)
    with pytest.raises(UnsupportedPNG):
        read_png(path)
    assert np.array_equal(frame_io.read_image(path),
                          np.array(Image.open(path)))
    write_png(path, image("L"))
    data = bytearray(path.read_bytes())
    data[28] = 1  # IHDR's interlace method
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    path.write_bytes(bytes(data))
    with pytest.raises(UnsupportedPNG, match="interlace 1"):
        read_png(path)


def test_corrupt_files_raise(tmp_path):
    path = tmp_path / "c.png"
    write_png(path, image("L"))
    data = bytearray(path.read_bytes())
    data[30] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(path)
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(path)


@pytest.mark.parametrize("kind", ["L", "RGB", "RGBA"])
def test_frame_readers_are_the_jax_packages(tmp_path, kind):
    path = tmp_path / "img.png"
    write_pil(path, kind, 6)
    for got, want in ((frame_io.read_image(path),
                       jax_frame_io.read_image(str(path))),
                      (np.array(frame_io.read_gen(str(path))),
                       np.array(jax_frame_io.read_gen(str(path))))):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_disparity_readers_are_the_jax_packages(tmp_path):
    kitti = tmp_path / "kitti.png"
    Image.fromarray(image("I;16")).save(kitti)
    for got, want in zip(frame_io.read_disp_kitti(str(kitti)),
                         jax_frame_io.read_disp_kitti(str(kitti))):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for sub in ("disparities", "occlusions"):
        (tmp_path / sub).mkdir()
    sintel = tmp_path / "disparities" / "f.png"
    Image.fromarray(image("RGB"), "RGB").save(sintel)
    Image.fromarray(((image("L") > 100) * 255).astype(np.uint8)).save(
        tmp_path / "occlusions" / "f.png")
    for got, want in zip(frame_io.read_disp_sintel(str(sintel)),
                         jax_frame_io.read_disp_sintel(str(sintel))):
        assert got.dtype == want.dtype and np.array_equal(got, want)
