"""Plain reference of the training step's data and update, for the
benchmark's check of a training cell.

Frozen copies (commit 5ab33e5), imported from nothing of the port:

* the resident scenes' fetch (``data/device_cache.py``
  ``fetch_scene_batch``): the disparity as 16-bit fixed point at 1/512 px,
  worked out again from the benchmark's float disparity;
* the augmentation on the card (``data/device_augment.py``): the same
  draws, from a generator seeded from (1234, step), and the same float32
  math;
* the sequence loss (``train/loss.py``);
* the update (``train/optim.py``): clip at global norm 1 in optax's form,
  AdamW (0.9, 0.999, 1e-8, decoupled decay), the OneCycle schedule of
  ``optax.linear_onecycle_schedule`` with the reference's arguments.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DISP_FIXED_POINT = 512.0


def fixed_point_flow(disp: torch.Tensor) -> torch.Tensor:
    """(B, H, W) disparity in px -> (B, H, W, 1) flow as the resident pack
    stores it: -round(d * 512) / 512, the words clipped to 16 bits."""
    q = torch.round(disp * DISP_FIXED_POINT).clamp(0, 65534)
    return -(q / DISP_FIXED_POINT).unsqueeze(-1)


@dataclasses.dataclass(frozen=True)
class AugmentSpec:
    """Static augmentation hyperparameters (FlowAugmentor ctor surface)."""

    src_hw: tuple  # raw sample (H, W) -- fixed-shape sources only
    crop_size: tuple
    min_scale: float = -0.2
    max_scale: float = 0.5
    do_flip: object = False  # False | "h" | "hf" | "v"
    yjitter: bool = False
    brightness: tuple = (0.6, 1.4)
    contrast: tuple = (0.6, 1.4)
    saturation: tuple = (0.6, 1.4)
    hue: float = 0.5 / 3.14
    gamma: tuple = (1.0, 1.0, 1.0, 1.0)
    asymmetric_prob: float = 0.2
    eraser_prob: float = 0.5
    eraser_bounds: tuple = (50, 100)
    stretch_prob: float = 0.8
    max_stretch: float = 0.2

    @classmethod
    def from_aug_params(cls, aug_params: dict, src_hw) -> "AugmentSpec":
        """Build from the config's augmentor kwargs (config.aug_params())."""
        p = dict(aug_params)
        kw = {
            "src_hw": tuple(src_hw),
            "crop_size": tuple(p.pop("crop_size")),
            "min_scale": p.pop("min_scale", -0.2),
            "max_scale": p.pop("max_scale", 0.5),
            "do_flip": p.pop("do_flip", False),
            "yjitter": p.pop("yjitter", False),
        }
        if "saturation_range" in p:
            kw["saturation"] = tuple(p.pop("saturation_range"))
        if "gamma" in p:
            kw["gamma"] = tuple(p.pop("gamma"))
        if p:
            raise ValueError(f"unsupported aug params for device augment: {p}")
        return cls(**kw)


# ---------------------------------------------------------------------------
# photometric primitives (the formulas of data/augment.py)
# ---------------------------------------------------------------------------


def _blend(a, b, f):
    return (f * a).add_((1.0 - f) * b).clamp_(0.0, 255.0)


def _gray(x):
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def adjust_hue(x, shift):
    """Hue rotation by ``shift`` turns (data/augment.py adjust_hue): x is
    (..., 3) in [0, 255], ``shift`` broadcasts against x[..., 0]."""
    xn = x / 255.0
    mx = xn.amax(-1)
    mn = xn.amin(-1)
    diff = mx - mn + 1e-12
    r, g, b = xn.unbind(-1)
    h = torch.where(mx == b, (r - g) / diff + 4,
                    torch.where(mx == g, (b - r) / diff + 2,
                                ((g - b) / diff) % 6))
    h = (h / 6.0 + shift) % 1.0
    s = torch.where(mx > 0, diff / (mx + 1e-12), 0.0)
    # HSV -> RGB in closed form: channel c = v (1 - s w_c), w_c =
    # clamp(min(k, 4 - k), 0, 1) for k = (n_c + 6 h) mod 6, n = (5, 3, 1);
    # the same values as the sextant table (v, q, p, p, t, v), (t, v, v, q,
    # p, p), (p, p, t, v, v, q) of data/augment.py, with fewer passes
    n = torch.arange(5.0, 0.0, -2.0, dtype=x.dtype, device=x.device)
    k = n.add((h * 6.0)[..., None]).remainder_(6.0)
    w = torch.minimum(k, 4.0 - k).clamp_(0.0, 1.0)
    out = (mx * s)[..., None].mul(w).neg_().add_(mx[..., None])
    return out.mul_(255.0).clamp_(0.0, 255.0)


def _color_pair(x, p, spec: AugmentSpec):
    """Random-order jitter on the views x (B, 2, H, W, 3), then gamma.

    Symmetric mode (shared order and factors) is the host path's
    stacked-pair jitter: every op is pixelwise except contrast, whose mean
    is taken over both images (the stacked image's mean), here the average
    of the two per-image means (equal pixel counts)."""
    order, factors, asym = p["color_order"], p["color_factors"], p["asym"]
    for i in range(4):
        gray = _gray(x)
        m = gray.mean((2, 3))
        mean = torch.where(asym[:, None], m, 0.5 * (m[:, :1] + m[:, 1:]))
        op = order[:, :, i]
        f = factors.gather(2, op[..., None])[..., 0]
        op5, f5 = op[..., None, None, None], f[..., None, None, None]
        # brightness blends with 0, contrast with the mean, saturation with
        # the gray image; hue rotates
        other = torch.where(op5 == 1, mean[..., None, None, None],
                            torch.where(op5 == 2, gray[..., None], 0.0))
        x = torch.where(op5 == 3, adjust_hue(x, f[..., None, None]),
                        _blend(x, other, f5))
    if tuple(spec.gamma) != (1.0, 1.0, 1.0, 1.0):
        g = p["gamma"][..., None, None, None]
        gain = p["gamma_gain"][..., None, None, None]
        x = torch.clamp(255.0 * gain * (x / 255.0) ** g, 0.0, 255.0)
    return x


def _eraser(x2, p):
    """Rectangle occlusions on img2 (B, H, W, 3), filled with its
    (pre-eraser) mean colour (FlowAugmentor.eraser_transform)."""
    h, w = x2.shape[1:3]
    mean_c = x2.mean((1, 2))
    yy = torch.arange(h, dtype=torch.float32, device=x2.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=x2.device)[None, :]
    x0, y0, dx, dy = (c[..., None, None] for c in p["eraser_rects"].unbind(-1))
    active = torch.stack([p["eraser_on"], p["eraser_on"] & p["eraser_two"]], 1)
    inside = (xx >= x0) & (xx < x0 + dx) & (yy >= y0) & (yy < y0 + dy)
    mask = (inside & active[..., None, None]).any(1)
    return torch.where(mask[..., None], mean_c[:, None, None, :], x2)


# ---------------------------------------------------------------------------
# spatial: joint resize + crop as one separable bilinear resampling
# ---------------------------------------------------------------------------


def _taps(coords, n):
    """Bilinear taps at sample positions, replicate borders (cv2
    INTER_LINEAR semantics): (i0, f), out = in[i0] (1 - f) + in[i0 + 1] f."""
    coords = coords.clamp(0.0, n - 1.0)
    i0 = torch.floor(coords).long().clamp(0, n - 2)
    return i0, coords - i0


def _resample(img, ys, xs):
    """Bilinear-sample img (N, H, W, C) at the outer product of ys (N, m)
    and xs (N, k): rows first, then columns."""
    n, h, w, c = img.shape
    iy, fy = _taps(ys, h)
    ix, fx = _taps(xs, w)
    m, k = ys.shape[1], xs.shape[1]

    def rows(i):
        return img.gather(1, i[:, :, None, None].expand(n, m, w, c))

    fy = fy[:, :, None, None]
    t = (1.0 - fy) * rows(iy) + fy * rows(iy + 1)

    def cols(i):
        return t.gather(2, i[:, None, :, None].expand(n, m, k, c))

    fx = fx[:, None, :, None]
    return (1.0 - fx) * cols(ix) + fx * cols(ix + 1)


def _spatial(x1, x2, flow, p, spec: AugmentSpec):
    h, w = spec.src_hw
    ch, cw = spec.crop_size
    sx, sy = p["scale_x"], p["scale_y"]
    # cv2.resize maps dst->src with the *rounded* output size's ratio
    nh = torch.round(h * sy)
    nw = torch.round(w * sx)

    if spec.do_flip:
        # flips commute with the (mirror-symmetric) resize, so apply them on
        # the source; reference order is resize -> flip -> crop
        if spec.do_flip == "hf":
            do = p["flip_h"][:, None, None, None]
            x1 = torch.where(do, x1.flip(2), x1)
            x2 = torch.where(do, x2.flip(2), x2)
            flow = torch.where(do, -flow.flip(2), flow)
        elif spec.do_flip == "h":
            do = p["flip_h"][:, None, None, None]
            # reference quirk mirrored: views swap, flow is NOT remapped
            x1, x2 = (torch.where(do, x2.flip(2), x1),
                      torch.where(do, x1.flip(2), x2))
        elif spec.do_flip == "v":
            do = p["flip_v"][:, None, None, None]
            x1 = torch.where(do, x1.flip(1), x1)
            x2 = torch.where(do, x2.flip(1), x2)
            flow = torch.where(do, flow.flip(1), flow)  # flow_y == 0

    if spec.yjitter:
        y0 = 2.0 + torch.floor(p["crop_u"] * (nh - ch - 4))
        x0 = 2.0 + torch.floor(p["crop_v"] * (nw - cw - 4))
        y1 = y0 + p["yjitter_delta"]
    else:
        y0 = torch.floor(p["crop_u"] * (nh - ch))
        x0 = torch.floor(p["crop_v"] * (nw - cw))
        y1 = y0
    dev = x1.device
    ar_h = torch.arange(ch, device=dev)
    ar_w = torch.arange(cw, device=dev)
    ys = (y0[:, None] + ar_h + 0.5) * (h / nh)[:, None] - 0.5
    ys2 = (y1[:, None] + ar_h + 0.5) * (h / nh)[:, None] - 0.5
    xs = (x0[:, None] + ar_w + 0.5) * (w / nw)[:, None] - 0.5
    b = x1.shape[0]
    both = _resample(torch.cat([x1, x2]), torch.cat([ys, ys2]),
                     torch.cat([xs, xs]))
    # flow x-values scale by the *unrounded* scale_x (FlowAugmentor :283)
    flow = _resample(flow, ys, xs) * sx[:, None, None, None]
    return both[:b], both[b:], flow


# ---------------------------------------------------------------------------
# random draws + batched entry points
# ---------------------------------------------------------------------------

N_UNIFORMS = 40  # uniforms drawn per sample
SEED = 1234  # the JAX package's augmentation key, PRNGKey(1234)


def step_generator(step: int, device) -> torch.Generator:
    """The generator of one step's draws, on ``device``: seeded from
    (``SEED``, ``step``), mixed by numpy's SeedSequence."""
    mixed = np.random.SeedSequence([SEED, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))


def draw_params(spec: AugmentSpec, u: torch.Tensor) -> dict:
    """Augmentation parameters from uniforms ``u`` (B, N_UNIFORMS) in
    [0, 1), one row a sample; the distributions of the JAX package's
    ``draw_params``."""
    h, w = spec.src_hw
    ch, cw = spec.crop_size

    def uni(j, lo, hi):
        return lo + (hi - lo) * u[:, j]

    def factors(j):
        return torch.stack([uni(j + k, lo, hi) for k, (lo, hi) in enumerate(
            [spec.brightness, spec.contrast, spec.saturation,
             (-spec.hue, spec.hue)])], -1)

    ord_a = u[:, 0:4].argsort(-1)
    ord_b = u[:, 4:8].argsort(-1)
    f_a, f_b = factors(8), factors(12)
    asym = u[:, 16] < spec.asymmetric_prob
    gmin, gmax, gainmin, gainmax = spec.gamma
    g_a = torch.stack([uni(17, gmin, gmax), uni(18, gmin, gmax)], -1)
    gain_a = torch.stack([uni(19, gainmin, gainmax),
                          uni(20, gainmin, gainmax)], -1)

    eb0, eb1 = spec.eraser_bounds
    er = u[:, 21:29].view(-1, 2, 4)
    rects = torch.stack([torch.floor(er[..., 0] * w),
                         torch.floor(er[..., 1] * h),
                         eb0 + torch.floor(er[..., 2] * (eb1 - eb0)),
                         eb0 + torch.floor(er[..., 3] * (eb1 - eb0))], -1)

    min_s = max((ch + 8) / h, (cw + 8) / w)
    scale = 2.0 ** uni(29, spec.min_scale, spec.max_scale)
    do_stretch = u[:, 30] < spec.stretch_prob
    st_x = 2.0 ** uni(31, -spec.max_stretch, spec.max_stretch)
    st_y = 2.0 ** uni(32, -spec.max_stretch, spec.max_stretch)
    scale_x = torch.clamp(scale * torch.where(do_stretch, st_x, 1.0), min=min_s)
    scale_y = torch.clamp(scale * torch.where(do_stretch, st_y, 1.0), min=min_s)

    a2 = asym[:, None]
    return {
        "color_order": torch.stack([ord_a, torch.where(a2, ord_b, ord_a)], 1),
        "color_factors": torch.stack([f_a, torch.where(a2, f_b, f_a)], 1),
        "asym": asym,
        "gamma": torch.where(a2, g_a, g_a[:, :1]),
        "gamma_gain": torch.where(a2, gain_a, gain_a[:, :1]),
        "eraser_on": u[:, 33] < spec.eraser_prob,
        "eraser_two": u[:, 34] < 0.5,
        "eraser_rects": rects,
        "scale_x": scale_x,
        "scale_y": scale_y,
        "crop_u": u[:, 35],
        "crop_v": u[:, 36],
        "yjitter_delta": torch.floor(u[:, 37] * 5.0) - 2.0,
        "flip_h": u[:, 38] < 0.5,
        "flip_v": u[:, 39] < 0.1,
    }


def apply_augment(spec: AugmentSpec, p: dict, img1, img2, flow):
    """Deterministic augmentation given drawn params (testable core).

    img1 / img2: (B, H, W, 3), any dtype in [0, 255]; flow: (B, H, W, 1);
    ``p``: :func:`draw_params`'s dict, its tensors on the images' device.
    Returns (img1, img2, flow, valid) at crop_size, float32."""
    x = torch.stack([img1, img2], 1).float()
    x1, x2 = _color_pair(x, p, spec).unbind(1)
    x2 = _eraser(x2, p)
    x1, x2, flow = _spatial(x1, x2, flow.float(), p, spec)
    # dense-GT valid recompute (data/datasets.py _get: |flow| < 512; the
    # y-component is identically zero for stereo)
    valid = (flow[..., 0].abs() < 512).float()
    return x1, x2, flow, valid


def augment(spec: AugmentSpec, step: int, img1, img2, flow):
    """The batch's augmentation at ``step``: one table of uniforms from
    :func:`step_generator`, a row a sample."""
    gen = step_generator(step, img1.device)
    u = torch.rand((img1.shape[0], N_UNIFORMS), generator=gen, device=img1.device)
    return apply_augment(spec, draw_params(spec, u), img1, img2, flow)


def sequence_loss(preds, flow_gt, valid, *, loss_gamma=0.9,
                  max_flow_magnitude=700.0):
    """Weights gamma^(n-1-i); L1 for the intermediate maps, smooth L1
    (beta 1) for the last; masked by valid and |flow| < the limit; float32."""
    gt = flow_gt.float()
    mask = ((valid.float() >= 0.5) & (gt.abs()[..., 0] < max_flow_magnitude))[..., None]
    den = mask.float().sum().clamp(min=1.0)
    total = torch.zeros((), device=gt.device)
    n = len(preds)
    for i, p in enumerate(preds):
        diff = gt - p.float()
        ad = diff.abs()
        err = (torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5) if i == n - 1
               else ad)
        total = total + loss_gamma ** (n - 1 - i) * (err * mask).sum() / den
    return total


def onecycle_lr(count: int, learn_rate: float, num_steps: int) -> float:
    """The learning rate of update ``count`` (0 first): linear from
    learn_rate / 25 up to learn_rate at update int(0.01 T), then linear down
    to learn_rate / 2.5e5 at T = num_steps + 100, constant after."""
    total = num_steps + 100
    b1, b2 = int(0.01 * total), total
    v0, v1 = learn_rate / 25.0, learn_rate
    v2 = v1 / (25.0 * 1e4)
    if count < b1:
        return v0 + (v1 - v0) * count / b1
    if count < b2:
        return v1 + (v2 - v1) * (count - b1) / (b2 - b1)
    return v2


class Update:
    """clip at global norm 1 (optax: scaled by 1 / norm above it), then
    AdamW at :func:`onecycle_lr` of the update's count."""

    def __init__(self, params, *, learn_rate, weight_decay, num_steps):
        self.params = [p for p in params if p.requires_grad]
        self.learn_rate, self.num_steps = learn_rate, num_steps
        self.adamw = torch.optim.AdamW(self.params, lr=learn_rate,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.count = 0

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        factor = torch.where(norm < 1.0, torch.ones_like(norm), 1.0 / norm)
        for g in grads:
            g.mul_(factor)
        for group in self.adamw.param_groups:
            group["lr"] = onecycle_lr(self.count, self.learn_rate, self.num_steps)
        self.adamw.step()
        self.count += 1
