"""Training augmentation on the host (port of the JAX package's
``realtime_stereo_matcher_tpu/data/augment.py``; reference
dataset/augmentor.py), numpy only.

The photometric ops re-implement torchvision ColorJitter semantics
(random-order brightness / contrast / saturation / hue, then gamma) in
numpy; the spatial ops mirror the reference:

* ``FlowAugmentor`` (dense GT, reference :60-182): asymmetric / symmetric
  colour jitter, eraser occlusion, random scale / stretch / flip, crop with
  y-jitter.
* ``SparseFlowAugmentor`` (KITTI / ETH3D, reference :184-317): symmetric
  jitter only, sparse flow resize by point splatting, margin crop.

Each augmentor owns a ``numpy.random.Generator`` so loader workers can be
seeded independently and deterministically.

The reference resizes with cv2's ``INTER_LINEAR``; the card's machine has no
cv2, so :func:`resize_linear` computes cv2's result in numpy: the same
geometry (source centre ``(i + 0.5) * n_in / n_out - 0.5`` in float32, the
ratio of the rounded output size; columns clamped to the edge with weight
0, rows read clamped), and on uint8 cv2's fixed-point arithmetic (11-bit
weights, and its vector path's vertical pass).  Against cv2 5.0 it gives
the same bits on uint8 images and on two-channel float32 ones (the flow);
on float32 with 1, 3 or 4 channels cv2 maps otherwise, by up to ~1.5e-5
relative.
"""

from __future__ import annotations

import numpy as np

_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE: 11-bit fixed-point weights


def _source_coords(n_in: int, n_out: int):
    """cv2's source coordinate of each output index: the float32 centre
    ``(i + 0.5) * n_in / n_out - 0.5`` (computed in double, then rounded),
    split into its floor and float32 fraction."""
    c = ((np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out)
         - 0.5).astype(np.float32)
    s = np.floor(c)
    return s.astype(np.int64), c - s


def _column_taps(n_in: int, n_out: int):
    """Columns: a centre left of 0 reads column 0 with weight 0, one at or
    past ``n_in - 1`` reads the last column with weight 0."""
    s, f = _source_coords(n_in, n_out)
    edge = (s < 0) | (s >= n_in - 1)
    s = np.clip(s, 0, n_in - 1)
    f[edge] = 0.0
    return s, np.minimum(s + 1, n_in - 1), f


def _row_taps(n_in: int, n_out: int):
    """Rows keep their fraction at the edges and read clamped rows."""
    s, f = _source_coords(n_in, n_out)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), f


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """cv2's ``INTER_LINEAR`` resize of an (H, W) or (H, W, C) uint8 or
    float32 image to ``round(h * fy)`` x ``round(w * fx)``; the mapping
    uses that size's ratio to the input size, as cv2's does."""
    h, w = img.shape[:2]
    nh, nw = int(round(h * fy)), int(round(w * fx))
    if (nh, nw) == (h, w):
        return img.copy()
    x0, x1, ax = _column_taps(w, nw)
    y0, y1, ay = _row_taps(h, nh)
    one = np.float32(1.0)
    im = img.reshape(h, w, -1)
    if img.dtype == np.uint8:
        # horizontal: integer sums of 11-bit weights (each rounded half to
        # even); vertical: cv2's vector path, (((r >> 4) * b) >> 16) per
        # row, then (sum + 2) >> 2
        a0 = np.rint((one - ax) * _COEF_SCALE).astype(np.int32)[None, :, None]
        a1 = np.rint(ax * _COEF_SCALE).astype(np.int32)[None, :, None]
        b0 = np.rint((one - ay) * _COEF_SCALE).astype(np.int32)[:, None, None]
        b1 = np.rint(ay * _COEF_SCALE).astype(np.int32)[:, None, None]
        rows = im[:, x0].astype(np.int32) * a0 + im[:, x1].astype(np.int32) * a1
        out = ((((rows[y0] >> 4) * b0) >> 16)
               + (((rows[y1] >> 4) * b1) >> 16) + 2) >> 2
        out = np.clip(out, 0, 255).astype(np.uint8)
    else:
        im = im.astype(np.float32)
        rows = (im[:, x0] * (one - ax)[None, :, None]
                + im[:, x1] * ax[None, :, None])
        out = (rows[y0] * (one - ay)[:, None, None]
               + rows[y1] * ay[:, None, None])
    return out.reshape((nh, nw) + img.shape[2:])


# ---------------------------------------------------------------------------
# photometric ops (torchvision ColorJitter semantics, numpy)
# ---------------------------------------------------------------------------


def _blend(a: np.ndarray, b: np.ndarray, f: float) -> np.ndarray:
    return np.clip(f * a + (1.0 - f) * b, 0, 255)


def adjust_brightness(img: np.ndarray, f: float) -> np.ndarray:
    return _blend(img.astype(np.float32), np.zeros_like(img, np.float32), f)


def adjust_contrast(img: np.ndarray, f: float) -> np.ndarray:
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    mean = gray.mean()
    return _blend(img.astype(np.float32), np.full_like(img, mean, np.float32), f)


def adjust_saturation(img: np.ndarray, f: float) -> np.ndarray:
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    return _blend(img.astype(np.float32), gray[..., None].astype(np.float32), f)


def adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    """shift in [-0.5, 0.5] turns of the hue circle.

    Vectorized with where/choose selections instead of boolean-mask writes
    (the masked form cost ~27 ms/sample and dominated the host augmentation
    profile); element-wise math and the tie-break order (b-max wins over
    g-max over r-max, like sequential masked writes) are unchanged.
    """
    x = img.astype(np.float32) / 255.0
    mx = x.max(-1)
    mn = x.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = np.where(mx == b, (r - g) / diff + 4,
                 np.where(mx == g, (b - r) / diff + 2,
                          ((g - b) / diff) % 6))
    h = (h / 6.0 + shift) % 1.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    v = mx
    # HSV -> RGB
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(np.intp) % 6
    out = np.stack([np.choose(i, (v, q, p, p, t, v)),
                    np.choose(i, (t, v, v, q, p, p)),
                    np.choose(i, (p, p, t, v, v, q))], axis=-1)
    return np.clip(out * 255.0, 0, 255)


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    return np.clip(255.0 * gain * np.power(x, gamma), 0, 255)


# --- CIELAB color-statistics transfer (reference dataset/augmentor.py:30-45;
# a style-transfer helper the reference keeps but never wires into the
# augmentors).  skimage is not available here, so the sRGB <-> CIELAB (D65)
# conversions are implemented directly in numpy.

_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]], np.float64)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)
_WHITE_D65 = np.array([0.95047, 1.0, 1.08883], np.float64)


def _srgb_to_linear(c):
    return np.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def _linear_to_srgb(c):
    c = np.clip(c, 0.0, 1.0)
    return np.where(c > 0.0031308, 1.055 * c ** (1 / 2.4) - 0.055, 12.92 * c)


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB in [0, 1] -> CIELAB (L in [0, 100]), D65 white point."""
    xyz = _srgb_to_linear(rgb.astype(np.float64)) @ _RGB2XYZ.T
    t = xyz / _WHITE_D65
    eps, kappa = (6 / 29) ** 3, (29 / 6) ** 2 / 3
    f = np.where(t > eps, np.cbrt(t), kappa * t + 4 / 29)
    fl, fa, fb = f[..., 0], f[..., 1], f[..., 2]
    return np.stack([116 * fa - 16, 500 * (fl - fa), 200 * (fa - fb)], -1)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """CIELAB -> (H, W, 3) RGB in [0, 1] (inverse of :func:`rgb_to_lab`)."""
    l, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (l + 16) / 116
    f = np.stack([fy + a / 500, fy, fy - b / 200], -1)
    eps, kappa = 6 / 29, (29 / 6) ** 2 / 3
    t = np.where(f > eps, f ** 3, (f - 4 / 29) / kappa)
    return _linear_to_srgb((t * _WHITE_D65) @ _XYZ2RGB.T)


def transfer_color(image: np.ndarray, style_mean: np.ndarray,
                   style_stddev: np.ndarray) -> np.ndarray:
    """Match the image's CIELAB channel statistics to a style's mean/stddev
    (reference dataset/augmentor.py:30-45).

    ``image`` is (H, W, 3) RGB in [0, 255]; ``style_mean``/``style_stddev``
    broadcast against (1, 1, 3) Lab stats.  L is clipped to [0, 100] before
    converting back; returns float RGB in [0, 255].
    """
    lab = rgb_to_lab(np.asarray(image, np.float64) / 255.0)
    mean = lab.mean(axis=(0, 1), keepdims=True)
    std = lab.std(axis=(0, 1), keepdims=True)
    out = (lab - mean) * (np.asarray(style_stddev) / std) + style_mean
    out[..., 0] = np.clip(out[..., 0], 0.0, 100.0)
    return lab_to_rgb(out) * 255.0


class ColorJitter:
    """Random-order brightness/contrast/saturation/hue + gamma, applied to a
    uint8 image (torchvision Compose([ColorJitter, AdjustGamma]) semantics,
    reference augmentor.py:47-58,82)."""

    def __init__(self, rng, brightness=0.4, contrast=0.4,
                 saturation=(0.6, 1.4), hue=0.5 / 3.14,
                 gamma=(1.0, 1.0, 1.0, 1.0)):
        self.rng = rng
        self.brightness = (max(0.0, 1 - brightness), 1 + brightness)
        self.contrast = (max(0.0, 1 - contrast), 1 + contrast)
        self.saturation = tuple(saturation)
        self.hue = (-hue, hue)
        self.gamma = tuple(gamma) if len(gamma) == 4 else (1, 1, 1, 1)

    def __call__(self, img: np.ndarray, rng=None) -> np.ndarray:
        rng = self.rng if rng is None else rng
        x = img.astype(np.float32)
        ops = list(range(4))
        rng.shuffle(ops)
        for op in ops:
            if op == 0:
                x = adjust_brightness(x, rng.uniform(*self.brightness))
            elif op == 1:
                x = adjust_contrast(x, rng.uniform(*self.contrast))
            elif op == 2:
                x = adjust_saturation(x, rng.uniform(*self.saturation))
            else:
                x = adjust_hue(x, rng.uniform(*self.hue))
        gmin, gmax, gainmin, gainmax = self.gamma
        if (gmin, gmax) != (1.0, 1.0):
            x = adjust_gamma(x, rng.uniform(gmin, gmax),
                             rng.uniform(gainmin, gainmax))
        return x.astype(np.uint8)


# ---------------------------------------------------------------------------
# augmentors
# ---------------------------------------------------------------------------


class FlowAugmentor:
    """Dense-GT augmentor (reference dataset/augmentor.py:60-182)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=True,
                 yjitter=False, saturation_range=(0.6, 1.4),
                 gamma=(1, 1, 1, 1), seed=None):
        self.rng = np.random.default_rng(seed)
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 1.0
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.yjitter = yjitter
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo = ColorJitter(self.rng, 0.4, 0.4, saturation_range,
                                 0.5 / 3.14, gamma)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5

    def seed(self, seed):
        self.rng = np.random.default_rng(seed)
        self.photo.rng = self.rng

    def color_transform(self, img1, img2, rng):
        if rng.random() < self.asymmetric_color_aug_prob:
            return self.photo(img1, rng), self.photo(img2, rng)
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.photo(stack, rng)
        return np.split(stack, 2, axis=0)

    def eraser_transform(self, img1, img2, rng, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            img2 = img2.copy()
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(bounds[0], bounds[1])
                dy = rng.integers(bounds[0], bounds[1])
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    def spatial_transform(self, img1, img2, flow, rng):
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 8) / float(ht),
                        (self.crop_size[1] + 8) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if rng.random() < self.stretch_prob:
            scale_x *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = np.clip(scale_x, min_scale, None)
        scale_y = np.clip(scale_y, min_scale, None)

        if (rng.random() < self.spatial_aug_prob or scale_x > 1.0
                or scale_y > 1.0):
            img1 = resize_linear(img1, scale_x, scale_y)
            img2 = resize_linear(img2, scale_x, scale_y)
            flow = resize_linear(flow, scale_x, scale_y)
            flow = flow * [scale_x, scale_y]

        if self.do_flip:
            if rng.random() < self.h_flip_prob and self.do_flip == "hf":
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if rng.random() < self.h_flip_prob and self.do_flip == "h":
                img1, img2 = img2[:, ::-1], img1[:, ::-1]
            if rng.random() < self.v_flip_prob and self.do_flip == "v":
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]

        if self.yjitter:
            y0 = rng.integers(2, img1.shape[0] - self.crop_size[0] - 2)
            x0 = rng.integers(2, img1.shape[1] - self.crop_size[1] - 2)
            y1 = y0 + rng.integers(-2, 3)
            img1 = img1[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
            img2 = img2[y1:y1 + self.crop_size[0], x0:x0 + self.crop_size[1]]
            flow = flow[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        else:
            y0 = rng.integers(0, img1.shape[0] - self.crop_size[0])
            x0 = rng.integers(0, img1.shape[1] - self.crop_size[1])
            img1 = img1[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
            img2 = img2[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
            flow = flow[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1, img2, flow

    def __call__(self, img1, img2, flow, rng=None):
        rng = self.rng if rng is None else rng
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow = self.spatial_transform(img1, img2, flow, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


class SparseFlowAugmentor:
    """Sparse-GT augmentor (reference dataset/augmentor.py:184-317)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False,
                 yjitter=False, saturation_range=(0.7, 1.3),
                 gamma=(1, 1, 1, 1), seed=None):
        self.rng = np.random.default_rng(seed)
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo = ColorJitter(self.rng, 0.3, 0.3, saturation_range,
                                 0.3 / 3.14, gamma)
        self.eraser_aug_prob = 0.5

    def seed(self, seed):
        self.rng = np.random.default_rng(seed)
        self.photo.rng = self.rng

    def color_transform(self, img1, img2, rng):
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.photo(stack, rng)
        return np.split(stack, 2, axis=0)

    def eraser_transform(self, img1, img2, rng):
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            img2 = img2.copy()
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(50, 100)
                dy = rng.integers(50, 100)
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        """Point-splat resize of a sparse flow map (reference :223-255)."""
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)), axis=-1)
        coords = coords.reshape(-1, 2).astype(np.float32)
        flow = flow.reshape(-1, 2).astype(np.float32)
        valid = valid.reshape(-1).astype(np.float32)

        coords0 = coords[valid >= 1]
        flow0 = flow[valid >= 1]

        ht1 = int(round(ht * fy))
        wd1 = int(round(wd * fx))

        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]

        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)

        v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        xx = xx[v]
        yy = yy[v]
        flow1 = flow1[v]

        flow_img = np.zeros([ht1, wd1, 2], dtype=np.float32)
        valid_img = np.zeros([ht1, wd1], dtype=np.int32)
        flow_img[yy, xx] = flow1
        valid_img[yy, xx] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid, rng):
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 1) / float(ht),
                        (self.crop_size[1] + 1) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = np.clip(scale, min_scale, None)
        scale_y = np.clip(scale, min_scale, None)

        if (rng.random() < self.spatial_aug_prob or scale_x > 1.0
                or scale_y > 1.0):
            img1 = resize_linear(img1, scale_x, scale_y)
            img2 = resize_linear(img2, scale_x, scale_y)
            flow, valid = self.resize_sparse_flow_map(flow, valid,
                                                      fx=scale_x, fy=scale_y)

        if self.do_flip:
            if rng.random() < self.h_flip_prob and self.do_flip == "hf":
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if rng.random() < self.h_flip_prob and self.do_flip == "h":
                img1, img2 = img2[:, ::-1], img1[:, ::-1]
            if rng.random() < self.v_flip_prob and self.do_flip == "v":
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]

        margin_y, margin_x = 20, 50
        y0 = rng.integers(0, img1.shape[0] - self.crop_size[0] + margin_y)
        x0 = rng.integers(-margin_x,
                          img1.shape[1] - self.crop_size[1] + margin_x)
        y0 = int(np.clip(y0, 0, img1.shape[0] - self.crop_size[0]))
        x0 = int(np.clip(x0, 0, img1.shape[1] - self.crop_size[1]))

        img1 = img1[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        img2 = img2[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        flow = flow[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        valid = valid[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1, img2, flow, valid

    def __call__(self, img1, img2, flow, valid, rng=None):
        rng = self.rng if rng is None else rng
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow, valid = self.spatial_transform(
            img1, img2, flow, valid, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid))
