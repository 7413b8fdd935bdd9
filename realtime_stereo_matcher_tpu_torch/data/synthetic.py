"""Procedural synthetic stereo scenes with exact ground-truth disparity
(port of the numpy path of ``realtime_stereo_matcher_tpu/data/synthetic.py``).

* the *right* image is a multi-octave value-noise texture (3 channels);
* the left-view disparity is a slanted background plane plus several
  soft-edged elliptical objects, each on its own closer slanted plane,
  composited with max();
* the *left* image is the right image sampled bilinearly at ``x - d(x, y)``,
  so the disparity is exact by construction;
* columns where ``x - d`` falls outside the right view are invalid.

Scene ``i`` of a seed is always the same, and the same as the JAX
package's scene ``i`` when that package has cv2: the noise resize is cv2's
``INTER_LINEAR`` geometry (half-pixel centres, edges clamped) and the remap
is exact float bilinear, as cv2's is on float32 maps, both written in numpy
here (the card's machine has no cv2).  :class:`SyntheticStereo` is the
map-style dataset of those scenes (the JAX package's, with the same
``seed0`` partition: held-out seeds from 10**6 are ``validate_synthetic``'s)
and :class:`SyntheticBatches` serves fixed-shape training batches, both in
the repo's sample contract: flow = -disparity, NHWC float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from realtime_stereo_matcher_tpu_torch.data.datasets import StereoDataset


@functools.lru_cache(maxsize=8)
def _grids(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy.setflags(write=False)
    xx.setflags(write=False)
    return yy, xx


def _linear_taps(n_in: int, n_out: int):
    """cv2 ``INTER_LINEAR`` taps along one axis: centres at
    ``(i + 0.5) * n_in / n_out - 0.5``; a centre below 0 reads index 0 with
    weight 0 and one at or past ``n_in - 1`` reads index ``n_in - 1`` with
    weight 0.  Returns (i0, i1, f): output = in[i0] * (1 - f) + in[i1] * f."""
    c = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(c).astype(np.int64)
    f = (c - i0).astype(np.float32)
    low, high = c < 0, i0 >= n_in - 1
    i0 = np.where(low, 0, np.where(high, n_in - 1, i0))
    f[low | high] = 0.0
    return i0, np.minimum(i0 + 1, n_in - 1), f


def _value_noise(rng, h, w, octaves=((8, 1.0), (24, 0.6), (64, 0.35)),
                 channels=3):
    """Sum of bilinearly-upsampled random grids, normalized to [0, 255]."""
    out = np.zeros((h, w, channels), np.float32)
    for cells, amp in octaves:
        gh, gw = max(2, int(cells * h / max(h, w))), max(2, cells)
        grid = rng.standard_normal((gh, gw, channels)).astype(np.float32)
        y0, y1, fy = _linear_taps(gh, h)
        x0, x1, fx = _linear_taps(gw, w)
        fy, fx = fy[:, None, None], fx[None, :, None]
        g = ((grid[y0][:, x0] * (1 - fx) + grid[y0][:, x1] * fx) * (1 - fy)
             + (grid[y1][:, x0] * (1 - fx) + grid[y1][:, x1] * fx) * fy)
        out += amp * g
    out -= out.min()
    out *= 255.0 / max(out.max(), 1e-6)
    return out


def _plane(rng, h, w, lo, hi, max_slope=0.03):
    """Slanted plane d(x, y) = a + b*x + c*y with range clipped to [lo, hi]."""
    a = rng.uniform(lo, hi)
    b = rng.uniform(-max_slope, max_slope)
    c = rng.uniform(-max_slope, max_slope)
    yy, xx = _grids(h, w)
    return np.clip(a + b * (xx - w / 2) + c * (yy - h / 2), lo, hi)


def make_scene(seed: int, h: int = 320, w: int = 448, max_disp: float = 64.0,
               n_objects: int = 5):
    """One synthetic stereo pair.

    Returns (left, right, disp, valid): uint8 images (H, W, 3), float32
    left-view disparity (H, W), float32 validity (H, W).
    """
    rng = np.random.default_rng(seed)
    margin = int(max_disp) + 4
    right_wide = _value_noise(rng, h, w + margin)  # extra left context

    disp = _plane(rng, h, w, 0.05 * max_disp, 0.35 * max_disp)
    yy, xx = _grids(h, w)
    for _ in range(int(rng.integers(max(1, n_objects - 2), n_objects + 1))):
        cx = rng.uniform(0.15 * w, 0.85 * w)
        cy = rng.uniform(0.15 * h, 0.85 * h)
        rx = rng.uniform(0.06, 0.22) * w
        ry = rng.uniform(0.08, 0.3) * h
        ang = rng.uniform(0, np.pi)
        dx, dy = xx - cx, yy - cy
        u = dx * np.cos(ang) + dy * np.sin(ang)
        v = -dx * np.sin(ang) + dy * np.cos(ang)
        inside = (u / rx) ** 2 + (v / ry) ** 2 < 1.0
        obj = _plane(rng, h, w, 0.4 * max_disp, 0.9 * max_disp)
        disp = np.where(inside, np.maximum(disp, obj), disp)
    disp = disp.astype(np.float32)

    # left(x) = right_wide(margin + x - d), bilinear in x
    src = margin + xx - disp
    x0 = np.floor(src).astype(np.int32)
    fx = (src - x0)[..., None]
    x0c = np.clip(x0, 0, w + margin - 2)
    rows = np.arange(h)[:, None]
    left = right_wide[rows, x0c] * (1 - fx) + right_wide[rows, x0c + 1] * fx

    valid = (src >= 0) & (src <= w + margin - 1)
    right = right_wide[:, margin:]
    return (left.astype(np.uint8), right.astype(np.uint8), disp,
            valid.astype(np.float32))


class SyntheticStereo(StereoDataset):
    """Map-style procedural dataset (contract of data/datasets.py).

    ``seed0`` partitions scenes: disjoint ranges give disjoint train/holdout
    sets.  Unaugmented, as evaluation reads it (``data/datasets.py``).
    """

    def __init__(self, aug_params=None, *, length: int = 2000,
                 seed0: int = 0, image_hw=(320, 448), max_disp: float = 64.0):
        super().__init__(aug_params)
        self.length = int(length)
        self.seed0 = int(seed0)
        self.image_hw = tuple(image_hw)
        self.max_disp = float(max_disp)
        # scenes are deterministic per (seed, index): memoize raw scenes
        # (~2 MB each at 320 x 448)
        self._cache: dict = {}
        # base-class bookkeeping so __mul__/ConcatDataset len() work
        self.image_list = [[f"synthetic://{seed0 + i}/left",
                            f"synthetic://{seed0 + i}/right"]
                           for i in range(self.length)]
        self.disparity_list = [f"synthetic://{seed0 + i}/disp"
                               for i in range(self.length)]
        self.extra_info = [[f"synthetic://{seed0 + i}"]
                           for i in range(self.length)]

    def __getitem__(self, index):
        index = index % self.length
        if index not in self._cache:
            self._cache[index] = make_scene(
                self.seed0 + index, *self.image_hw, max_disp=self.max_disp)
        img1, img2, disp, valid = self._cache[index]
        flow = -disp[..., None].astype(np.float32)
        return (self.image_list[index] + [self.disparity_list[index]],
                img1.astype(np.float32), img2.astype(np.float32), flow,
                np.asarray(valid, np.float32))


class SyntheticBatches:
    """A seeded, re-iterable loader of fixed-shape training batches.

    Each pass yields ``n_batches`` tuples ``(names, img1, img2, flow,
    valid)`` -- the JAX package's loader contract: img (B, H, W, 3) float32
    in [0, 255], flow (B, H, W, 1) = -disparity, valid (B, H, W).  Scene
    ``seed0 + k`` fills slot k; the scenes are made once, up front, and held
    on ``device``, so iterating costs no host work."""

    def __init__(self, batch_size: int, image_hw, *, n_batches: int = 1,
                 seed0: int = 0, max_disp: float = 64.0, device="cpu"):
        h, w = image_hw
        n = batch_size * n_batches
        scenes = [make_scene(seed0 + k, h, w, max_disp=max_disp)
                  for k in range(n)]

        def stack(i, dtype=np.float32):
            return torch.from_numpy(np.stack([s[i] for s in scenes]
                                             ).astype(dtype)).to(device)

        self.img1, self.img2 = stack(0), stack(1)
        self.flow = -stack(2)[..., None]
        self.valid = stack(3)
        self.batch_size = batch_size
        self.n_batches = n_batches
        self.names = [f"synthetic://{seed0 + k}" for k in range(n)]

    def __len__(self) -> int:
        return self.n_batches

    def __iter__(self):
        b = self.batch_size
        for i in range(self.n_batches):
            s = slice(i * b, (i + 1) * b)
            yield (self.names[s], self.img1[s], self.img2[s], self.flow[s],
                   self.valid[s])
