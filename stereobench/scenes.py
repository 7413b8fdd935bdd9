"""Synthetic stereo scenes made on the card from a seed.

A frozen copy, batched and moved to the device, of ``make_scene`` in
``realtime_stereo_matcher_tpu_torch/data/synthetic.py`` (commit 5ab33e5):
the right view is a three-octave value-noise texture, the left-view
disparity a slanted background plane with elliptical objects on closer
slanted planes (composited with max), and the left view the right one
sampled bilinearly at ``x - d``.  The draws come from a ``torch.Generator``
on the card, so the scenes differ from the port's numpy ones, and every
scene of a batch has the same number of objects.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

OCTAVES = ((8, 1.0), (24, 0.6), (64, 0.35))
N_OBJECTS = 5


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _value_noise(gen, n, h, w, device):
    out = torch.zeros((n, 3, h, w), device=device)
    for cells, amp in OCTAVES:
        gh, gw = max(2, int(cells * h / max(h, w))), max(2, cells)
        grid = torch.randn((n, 3, gh, gw), generator=gen, device=device)
        out += amp * F.interpolate(grid, size=(h, w), mode="bilinear",
                                   align_corners=False)
    lo = out.amin(dim=(1, 2, 3), keepdim=True)
    hi = out.amax(dim=(1, 2, 3), keepdim=True)
    return (out - lo) * (255.0 / (hi - lo).clamp(min=1e-6))


def _planes(gen, n, yy, xx, lo, hi, max_slope=0.03):
    h, w = yy.shape
    dev = yy.device
    a = _uniform(gen, (n, 1, 1), lo, hi, dev)
    b = _uniform(gen, (n, 1, 1), -max_slope, max_slope, dev)
    c = _uniform(gen, (n, 1, 1), -max_slope, max_slope, dev)
    return (a + b * (xx - w / 2) + c * (yy - h / 2)).clamp(lo, hi)


@torch.no_grad()
def make_pairs(n: int, h: int, w: int, *, max_disp: float, seed: int,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` stereo pairs (left, right), each (n, h, w, 3) uint8 on
    ``device``, with disparities up to 0.9 ``max_disp`` px."""
    return make_scenes(n, h, w, max_disp=max_disp, seed=seed, device=device)[:2]


@torch.no_grad()
def make_scenes(n: int, h: int, w: int, *, max_disp: float, seed: int,
                device):
    """``n`` scenes (left, right, disp): uint8 (n, h, w, 3) views and the
    left view's float32 disparity (n, h, w) in px, exact by construction.
    Every pixel is valid: the right view is made ``max_disp`` + 4 px wider
    on the left, so ``x - d`` never leaves it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    margin = int(max_disp) + 4
    right_wide = _value_noise(gen, n, h, w + margin, device)
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    disp = _planes(gen, n, yy, xx, 0.05 * max_disp, 0.35 * max_disp)
    for _ in range(N_OBJECTS):
        cx = _uniform(gen, (n, 1, 1), 0.15 * w, 0.85 * w, device)
        cy = _uniform(gen, (n, 1, 1), 0.15 * h, 0.85 * h, device)
        rx = _uniform(gen, (n, 1, 1), 0.06, 0.22, device) * w
        ry = _uniform(gen, (n, 1, 1), 0.08, 0.3, device) * h
        ang = _uniform(gen, (n, 1, 1), 0.0, math.pi, device)
        dx, dy = xx - cx, yy - cy
        u = dx * torch.cos(ang) + dy * torch.sin(ang)
        v = -dx * torch.sin(ang) + dy * torch.cos(ang)
        inside = (u / rx) ** 2 + (v / ry) ** 2 < 1.0
        obj = _planes(gen, n, yy, xx, 0.4 * max_disp, 0.9 * max_disp)
        disp = torch.where(inside, torch.maximum(disp, obj), disp)
    src = margin + xx - disp                       # (n, h, w)
    x0 = torch.floor(src)
    fx = (src - x0)[:, None]
    x0 = x0.long().clamp(0, w + margin - 2)[:, None].expand(n, 3, h, w)
    left = (right_wide.gather(3, x0) * (1 - fx)
            + right_wide.gather(3, x0 + 1) * fx)
    right = right_wide[..., margin:]
    to_u8 = lambda t: t.permute(0, 2, 3, 1).to(torch.uint8).contiguous()
    return to_u8(left), to_u8(right), disp
