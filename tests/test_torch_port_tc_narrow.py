"""The tensor-core kernels of the narrow channel pairs, on the CPU: K1
(``fused_conv3x3``, bf16, stride 1) at 1 / 3 / 4 / 7 -> 32 and 32 -> 1 / 4 / 7
(``csrc/conv_narrow_tc.cuh``) and K4 (``dw_reduce``, bf16) at 4 / 7 -> 32 and
32 -> 1, 2D and 3D (``csrc/dw_tc.cuh``).

The kernels run only on the card (``-m cuda`` here, where those tests skip).
Here:

* their tile plans at every main-path shape of the pairs and at ragged ones:
  each output pixel (each g pixel for K4) is covered by exactly one block,
  shared memory fits the 232,448 B a block may opt in to on an H100, the
  grid's y within 65,535, and the 720p and training launches fill the card;
* a numpy emulation of each kernel's packed layout as the kernels index it,
  every staged slot NaN until a copy fills it: the narrow side padded to 8
  channels, K1's taps two to a k16 step with a zero tenth tap, C_out padded
  to 8, and K4's transposed form (a tap row's three taps in two m16 tiles);
  A @ B gives ``fused_conv3x3_plain`` and the transposed form
  ``dw_reduce_plain`` / ``dw_reduce3d_plain``, for every pair at dilations 1,
  4 and 8 on ragged shapes;
* on CPU tensors the bf16 wrappers run their plain versions, which agree
  with the JAX package's ``flat_conv3x3`` (its Pallas kernel, in interpret
  mode on the CPU as the JAX package's own tests run it) followed by the
  epilogue, within one bf16 ulp, and with ``jax.grad`` of ``flat_conv3x3``
  / ``flat_conv3d`` (K4) within 1e-2 of the output's scale, on the same
  bf16 values (the JAX flat layout pads every pair to 32 channels).

JAX is imported inside the tests that use it, so that the file runs on the
card, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_tc_narrow.py
"""

import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    GRID_YZ_MAX,
    TC_NARROW,
    Card,
    conv3x3_tc_plan,
    fused_conv3x3,
    fused_conv3x3_plain,
)
from realtime_stereo_matcher_tpu_torch.kernels.train_conv import (
    SUPPORTED_CHANNELS,
    dw_blocks_per_sm,
    dw_reduce,
    dw_reduce3d,
    dw_reduce3d_plain,
    dw_reduce_plain,
    dw_tc_plan,
)

H100 = Card(sms=132, smem_per_sm=233_472)
SMEM_MAX = 232_448
NARROW = sorted(TC_NARROW)
DW_NARROW = [(1, p) for p in sorted(SUPPORTED_CHANNELS[1]) if p != (32, 32)] \
    + [(3, p) for p in sorted(SUPPORTED_CHANNELS[3]) if p != (32, 32)]

# (n, h, w) of the narrow K1 launches: the 720p frame's refine levels (the
# v3 stem at full size), the v1 step's (batch 4, 480 x 640 and down), the v2
# / v3 step's (batch 8, 240 x 320 and down); then ragged
K1_SHAPES = ([(1, 720 >> k, 1280 >> k) for k in range(3)]
             + [(4, 480 >> k, 640 >> k) for k in range(3)]
             + [(8, 240 >> k, 320 >> k) for k in range(3)]
             + [(3, 37, 53), (2, 9, 130)])
# (n, d, h, w) of the narrow K4 launches (2D: d = 1), then ragged
DW_SHAPES = {1: [(4, 1, 480 >> k, 640 >> k) for k in range(3)]
             + [(8, 1, 240 >> k, 320 >> k) for k in range(3)]
             + [(3, 1, 37, 53), (1, 1, 5, 130)],
             3: [(4, 24, 60, 80), (8, 24, 30, 40), (2, 5, 17, 33)]}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _bf16_values(rng, shape, scale=1.0):
    """float64 arrays of bf16-representable values."""
    a = torch.from_numpy((rng.uniform(-1, 1, shape) * scale)
                         .astype(np.float32)).bfloat16()
    return a.double().numpy()


# ---------------------------------------------------------------------------
# K1: plans, and an emulation of csrc/conv_narrow_tc.cuh
# ---------------------------------------------------------------------------


def _conv_blocks(plan):
    """Per block, (n, x0, y0, steps) as the kernels map ``blockIdx``."""
    n, _, h, _ = plan.shape
    gx, gy, gz = plan.grid
    for b in range(gz):
        for by in range(gy):
            for bx in range(gx):
                y0 = by * plan.steps * plan.th
                yield b, bx * plan.tw, y0, min(plan.steps,
                                               -(-(h - y0) // plan.th))


@pytest.mark.parametrize("pair", NARROW)
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_narrow_conv_plan_covers_each_pixel_once(pair, shape):
    n, h, w = shape
    cin, cout = pair
    for d in ((1, 4, 8) if h == 37 else (1,)):
        plan = conv3x3_tc_plan(n, h, w, d, H100, cin, cout)
        # what launch_narrow_tc accepts: 8 x 64 tiles, a ring of 2 * 8 + 2 d
        # rows; shared memory: the weights (80 rows of 64 B in, 288 of 16 B
        # out), the ring (16-byte narrow or 64-byte pixels), 8 KB staging
        assert (plan.th, plan.tw, plan.ring) == (8, 64, 16 + 2 * d)
        up = 64 + 2 * d
        want = (80 * 64 + plan.ring * up * 16 if cout == 32 else
                288 * 16 + plan.ring * up * 64) + 8 * 1024
        assert plan.smem == want <= SMEM_MAX
        tiles_h = -(-h // 8)
        assert plan.grid == (-(-w // 64), -(-tiles_h // plan.steps), n)
        assert plan.grid[1] <= GRID_YZ_MAX and plan.grid[2] <= GRID_YZ_MAX
        hits = np.zeros((n, h, w), np.int32)
        for b, x0, y0, steps in _conv_blocks(plan):
            assert steps >= 1
            hits[b, y0:y0 + steps * 8, x0:x0 + 64] += 1
        np.testing.assert_array_equal(hits, 1)


@pytest.mark.parametrize("pair", NARROW)
def test_narrow_conv_plan_fills_the_card(pair):
    """The 720p level-0 launch (the v1 / v2 entries and heads, the v3 stem)
    and the v1 step's largest launch run about one full wave of two blocks
    an SM: no SM idles for a second wave."""
    for n, h, w in ((1, 720, 1280), (4, 480, 640)):
        plan = conv3x3_tc_plan(n, h, w, 1, H100, *pair)
        blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
        slots = 2 * H100.sms
        assert 0.9 * slots <= blocks <= slots or blocks % slots >= 0.9 * slots


def _pad8(a):
    """Zero-pad the channel axis to 8 (a staged narrow pixel)."""
    out = np.zeros(a.shape[:-1] + (8,))
    out[..., :a.shape[-1]] = a
    return out


def emulate_conv_narrow(x, w, plan):
    """``conv_nin_tc_kernel`` / ``conv_nout_tc_kernel`` in float64 without
    the epilogue: the same ring loads into NaN-filled slots (committed
    after the step's MMAs, as the kernels do), the same staged weights and
    the same A addresses per lane.  Returns the conv (n, h, w, C_out) and how
    often each output pixel was stored."""
    n, _, h, wd = plan.shape
    cin, cout = x.shape[-1], w.shape[-1]
    d, ring, up = plan.dilation, plan.ring, 64 + 2 * plan.dilation
    narrow_in = cout == 32
    if narrow_in:  # 80 rows (tap * 8 + ci) of 32 co; rows 72-79 zero
        wst = np.zeros((80, 32))
        for t in range(9):
            wst[t * 8:t * 8 + cin] = w[t // 3, t % 3]
    else:          # 288 rows (tap * 32 + ci) of 8 co
        wst = _pad8(w.reshape(288, cout))
    out = np.full((n, h, wd, cout), np.nan)
    flat = out.reshape(-1)
    stores = np.zeros((n, h, wd), np.int64)
    lane = np.arange(32)
    for b, x0, y0, n_steps in _conv_blocks(plan):
        u0 = y0 - d
        rs = np.full((ring * up, 8 if narrow_in else 32), np.nan)

        def load(lo, rows):
            i = np.arange(rows * up)
            u, ix = lo + i // up, x0 - d + i % up
            ok = (u >= 0) & (u < h) & (ix >= 0) & (ix < wd)
            v = np.zeros((i.size, cin))
            v[ok] = x[b, u[ok], ix[ok]]
            rs[((u - u0) % ring) * up + i % up] = _pad8(v) if narrow_in else v

        load(u0, 8 + 2 * d)
        for s in range(n_steps):
            for warp in range(8):
                oy = y0 + s * 8 + warp
                for m in range(4):
                    if narrow_in:
                        # lane l addresses pixel l & 15 at tap 2 ks + (l >> 4)
                        a = np.zeros((16, 80))
                        for ks in range(5):
                            t = np.minimum(2 * ks + (lane >> 4), 8)
                            off = (((oy + (t // 3 - 1) * d - u0) % ring) * up
                                   + (t % 3) * d + (lane & 15) + m * 16)
                            for half in (0, 1):
                                if ks == 4 and half == 1:
                                    continue  # zero in registers
                                sel = (lane >> 4) == half
                                a[lane[sel] & 15,
                                  ks * 16 + 8 * half:ks * 16 + 8 * half + 8] \
                                    = rs[off[sel]]
                    else:
                        a = np.zeros((16, 288))
                        for t in range(9):
                            unit = ((oy + (t // 3 - 1) * d - u0) % ring) * up
                            a[:, t * 32:t * 32 + 32] = rs[
                                unit + m * 16 + (t % 3) * d + np.arange(16)]
                    acc = a @ wst
                    ox = x0 + m * 16
                    valid = min(16, wd - ox) if oy < h else 0
                    if valid <= 0:
                        continue
                    if narrow_in:
                        out[b, oy, ox:ox + valid] = acc[:valid]
                    else:  # compact staging, stored element by element
                        st = acc[:valid, :cout].reshape(-1)
                        base = ((b * h + oy) * wd + ox) * cout
                        flat[base:base + st.size] = st
                    stores[b, oy, ox:ox + valid] += 1
            if s + 1 < n_steps:
                load(y0 + (s + 1) * 8 + d, 8)
    return out, stores


@pytest.mark.parametrize("pair", NARROW)
@pytest.mark.parametrize("dilation", [1, 4, 8])
def test_narrow_conv_emulation_matches_plain(pair, dilation):
    """A (packed taps / 32-channel rows) @ B (padded weights), as the kernels
    index them, is the plain conv; each output pixel is stored once."""
    cin, cout = pair
    rng = _rng(5)
    n, h, w = (2, 19, 70) if dilation == 4 else (1, 21, 37)
    x = rng.uniform(-1, 1, (n, h, w, cin))
    wt = rng.uniform(-1, 1, (3, 3, cin, cout))
    # a card of 1 SM: several steps a block, so the ring wraps
    plan = conv3x3_tc_plan(n, h, w, dilation, Card(1, 233_472), cin, cout)
    assert plan.steps > 1
    got, stores = emulate_conv_narrow(x, wt, plan)
    one, zero = torch.ones(cout, dtype=torch.float64), torch.zeros(
        cout, dtype=torch.float64)
    want = fused_conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wt), one,
                               zero, dilation=dilation, act="none")
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-9)
    np.testing.assert_array_equal(stores, 1)


# ---------------------------------------------------------------------------
# K4: plans, and an emulation of csrc/dw_tc.cuh at the narrow pairs
# ---------------------------------------------------------------------------


def _dw_blocks(plan):
    """Per block, (kz, x0, first g row, steps, partial slot)."""
    n, d, h, w = plan.shape
    rows = n * d * h
    gx, gy, gz = plan.grid
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                r0 = by * plan.steps * plan.th
                yield (bz if plan.kd == 3 else 1, bx * plan.tw, r0,
                       min(plan.steps, -(-(rows - r0) // plan.th)),
                       (by * gx + bx) * plan.kd + (bz if plan.kd == 3 else 0))


@pytest.mark.parametrize("kd,pair", DW_NARROW)
def test_narrow_dw_plan_reduces_each_pixel_once(kd, pair):
    cin, cout = pair
    for n, d, h, w in DW_SHAPES[kd]:
        for dil in ((1, 4, 8) if kd == 1 and h == 37 else (1,)):
            plan = dw_tc_plan(n, d, h, w, kd, dil, H100, cin, cout)
            assert plan.th == 8 and plan.tw % 16 == 0 and plan.tw >= 16
            assert plan.ring == 16 + 2 * dil
            up = plan.tw + 2 * dil
            # what launch_dw_tc accepts: a 32-channel row one 16-byte chunk
            # a thread, a later step's narrow pixels at most 2 a thread
            assert (up * 4 if cin == 32 else 8 * up) <= (384 if cin == 32
                                                         else 768)
            xpix, gpix = (64 if cin == 32 else 16), (64 if cout == 32 else 16)
            stream = plan.ring * up * xpix + 2 * 8 * plan.tw * gpix
            assert plan.smem == max(stream, 9 * cin * cout * 4) <= SMEM_MAX
            tiles = -(-(n * d * h) // 8)
            gx, gy, gz = plan.grid
            assert (gx, gy, gz) == (-(-w // plan.tw), -(-tiles // plan.steps),
                                    kd)
            assert 1 <= gy <= GRID_YZ_MAX
            assert plan.work_floats == gx * gy * gz * 9 * cin * cout
            hits = np.zeros((kd, n * d * h, w), np.int32)
            slots = []
            for kz, x0, r0, steps, slot in _dw_blocks(plan):
                assert steps >= 1
                hits[kz if kd == 3 else 0, r0:r0 + steps * 8,
                     x0:x0 + plan.tw] += 1
                slots.append(slot)
            np.testing.assert_array_equal(hits, 1)
            assert sorted(slots) == list(range(gx * gy * gz))


@pytest.mark.parametrize("kd,pair", DW_NARROW)
def test_narrow_dw_plan_fills_the_card(kd, pair):
    """The largest training launch of each pair runs about one wave of two
    blocks an SM (a narrow pair holds at most 32 accumulators a thread, so
    two 384-thread blocks fit in an SM's registers, and their shared memory
    fits too), so its workspace is about one partial a block slot."""
    n, d, h, w = DW_SHAPES[kd][0]
    plan = dw_tc_plan(n, d, h, w, kd, 1, H100, *pair)
    assert dw_blocks_per_sm(plan.smem, H100, *pair) == 2
    assert 2 * (plan.smem + 1024) <= H100.smem_per_sm
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert 0.9 * 2 * H100.sms <= blocks <= 2 * H100.sms


def emulate_dw_narrow(x, g, plan):
    """``dw_tc_kernel`` at a narrow pair, then ``dw_sum_kernel``, in float64:
    the same loads into a NaN-filled ring and g buffers (the narrow side
    padded to 8 channels, the narrow pixels of step s + 1 committed after
    step s's MMAs), the same row skips, the same A tiles ((kx 0, kx 1) and
    (kx 2, zero) for a narrow x; (kx, ci half) for 32 channels) and B (g,
    32 channels or padded to 8), the same partial layout and summation
    order.  Returns dW (kd, 3, 3, C_in, C_out)."""
    n, d, h, w = plan.shape
    cin, cout = x.shape[-1], g.shape[-1]
    rows, th, tw, ring, dil = n * d * h, plan.th, plan.tw, plan.ring, \
        plan.dilation
    X, G = x.reshape(rows, w, cin), g.reshape(rows, w, cout)
    up = tw + 2 * dil
    xw, gw_ = (8 if cin < 32 else 32), (8 if cout < 32 else 32)
    gx, gy, gz = plan.grid
    parts = np.full((gx * gy * plan.kd, 9, cin, cout), np.nan)
    for kz, x0, r0, n_steps, slot in _dw_blocks(plan):
        xoff = (kz - 1) * h
        u0 = r0 + xoff - dil
        xs = np.full((ring * up, xw), np.nan)
        gs = np.full((2, th * tw, gw_), np.nan)

        def load_x(lo, hi):
            u = np.repeat(np.arange(lo, hi + 1), up)
            p = np.tile(np.arange(up), hi - lo + 1)
            ix = x0 - dil + p
            ok = (u >= 0) & (u < rows) & (ix >= 0) & (ix < w)
            v = np.zeros((u.size, xw))
            v[ok, :cin] = X[u[ok], ix[ok]]
            xs[((u - u0) % ring) * up + p] = v

        def load_g(s):
            r = np.repeat(np.arange(th), tw)
            p = np.tile(np.arange(tw), th)
            row, ix = r0 + s * th + r, x0 + p
            ok = (row < rows) & (ix < w)
            v = np.zeros((r.size, gw_))
            v[ok, :cout] = G[row[ok], ix[ok]]
            gs[s & 1] = v

        def lo_of(s):
            return u0 if s == 0 else u0 + s * th + 2 * dil

        load_x(lo_of(0), u0 + th - 1 + 2 * dil)
        load_g(0)
        red = np.zeros((3, 3, cin, cout))
        for s in range(n_steps):
            for warp in range(12):
                ky, slice_ = warp % 3, warp // 3
                for r in (slice_, slice_ + 4):
                    row = r0 + s * th + r
                    if row >= rows:
                        break
                    if not 0 <= row % h + (ky - 1) * dil < h:
                        continue
                    if plan.kd == 3 and not 0 <= (row // h) % d + kz - 1 < d:
                        continue
                    unit = ((s * th + r + ky * dil) % ring) * up
                    for c0 in range(0, tw, 16):
                        if x0 + c0 >= w:
                            break
                        b = gs[s & 1, r * tw + c0:r * tw + c0 + 16]  # (k, n)
                        if cin < 32:
                            px = unit + c0 + np.arange(16)
                            a0 = np.concatenate([xs[px].T, xs[px + dil].T])
                            a1 = np.concatenate([xs[px + 2 * dil].T,
                                                 np.zeros((8, 16))])
                            for kx, (a, lo_) in enumerate(
                                    ((a0, 0), (a0, 8), (a1, 0))):
                                red[ky, kx] += (a @ b)[lo_:lo_ + cin, :cout]
                        else:
                            for kx in range(3):
                                a = xs[unit + c0 + kx * dil:
                                       unit + c0 + kx * dil + 16].T
                                red[ky, kx] += (a @ b)[:, :cout]
            if s + 1 < n_steps:
                load_x(lo_of(s + 1), u0 + (s + 1) * th + th - 1 + 2 * dil)
                load_g(s + 1)
        parts[slot] = red.reshape(9, cin, cout)
    out = np.zeros((plan.kd * 9, cin, cout))
    for p in range(gx * gy):  # dw_sum_kernel: partials in order
        out += parts[p * plan.kd:(p + 1) * plan.kd].reshape(-1, cin, cout)
    return out.reshape(plan.kd, 3, 3, cin, cout)


@pytest.mark.parametrize("kd,pair,dilation", [
    (kd, pair, d) for kd, pair in DW_NARROW for d in ((1, 4, 8) if kd == 1
                                                      else (1,))])
def test_narrow_dw_emulation_matches_plain(kd, pair, dilation):
    """The transposed form (M = tap x ci, N = co, K = pixels) as the kernel
    stages and indexes it is the plain dW (the 3D form at dilation 1, the
    only one it has)."""
    cin, cout = pair
    rng = _rng(6)
    shape = (2, 5, 9, 21) if kd == 3 else ((2, 1, 19, 37) if dilation != 4
                                           else (1, 1, 21, 70))
    x = rng.uniform(-1, 1, (*shape, cin))
    g = rng.uniform(-1, 1, (*shape, cout))
    plan = dw_tc_plan(*shape, kd, dilation, Card(4, 233_472), cin, cout)
    got = emulate_dw_narrow(x, g, plan)
    if kd == 1:
        want = dw_reduce_plain(torch.from_numpy(x[:, 0]),
                               torch.from_numpy(g[:, 0]), dilation)[None]
    else:
        want = dw_reduce3d_plain(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-9)


# ---------------------------------------------------------------------------
# the CPU wrappers against the JAX package's kernels
# ---------------------------------------------------------------------------

# one shape for every pair: the JAX flat layout pads each pair to 32
# channels, so its interpret-mode kernel compiles once per test process
JAX_SHAPE = (2, 9, 36)
# the epilogue each pair has on the model paths
PAIR_ACT = {(4, 32): "relu", (7, 32): "relu", (3, 32): 0.2, (1, 32): "none",
            (32, 1): "none", (32, 4): "none", (32, 7): "none"}


def _jax_flat_conv(x32, w32):
    """The JAX package's ``flat_conv3x3`` (dilation 1) on (B, H, W, 32)
    float32 values, through its flat layout, back to (B, H, W, 32)."""
    from realtime_stereo_matcher_tpu.kernels.train_conv import (
        _fold_selector,
        flat_conv3x3,
        from_flat_batch,
        to_flat_batch,
    )

    b, h, w, _ = x32.shape
    yf = flat_conv3x3(to_flat_batch(x32), w32, 1, 0)
    return from_flat_batch(yf, b, h, w, 32, phase=_fold_selector(1, 0)[3])


def _pad32(a, axes):
    pad = [(0, 0)] * a.ndim
    for ax in axes:
        pad[ax] = (0, 32 - a.shape[ax])
    return np.pad(a, pad)


@pytest.mark.parametrize("pair", NARROW)
def test_bf16_narrow_conv_on_cpu_runs_plain_and_matches_jax(pair):
    """bf16 ``fused_conv3x3`` at a narrow pair on CPU tensors (its epilogue
    on the model path) against the JAX package's ``flat_conv3x3`` on the
    same bf16 values, channels zero-padded to 32 as its flat layout needs,
    then scale, bias, activation and a bf16 cast: within one bf16 ulp (two
    float32 sums of the same products in another order can round to
    adjacent bf16 values)."""
    import jax.numpy as jnp

    cin, cout = pair
    act = PAIR_ACT[pair]
    rng = _rng(7)
    x = _bf16_values(rng, (*JAX_SHAPE, cin))
    w = _bf16_values(rng, (3, 3, cin, cout), 1 / np.sqrt(9 * cin))
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, cout).astype(np.float32)
    got = fused_conv3x3(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(w).bfloat16(),
                        torch.from_numpy(scale), torch.from_numpy(bias),
                        act=act)
    assert got.dtype == torch.bfloat16 and got.shape == (*JAX_SHAPE, cout)
    y = _jax_flat_conv(jnp.asarray(_pad32(x, [3]), jnp.float32),
                       jnp.asarray(_pad32(w, [2, 3]), jnp.float32))
    y = np.asarray(y)[..., :cout] * scale + bias
    if act == "relu":
        y = np.maximum(y, 0.0)
    elif isinstance(act, float):
        y = np.maximum(y, 0.0) + act * np.minimum(y, 0.0)
    y = torch.from_numpy(y.astype(np.float32)).bfloat16().float().numpy()
    np.testing.assert_allclose(got.float().numpy(), y, rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.parametrize("kd,pair", DW_NARROW)
def test_bf16_narrow_dw_on_cpu_runs_plain_and_matches_jax(kd, pair):
    """bf16 ``dw_reduce`` / ``dw_reduce3d`` at a narrow pair on CPU tensors
    against the weight gradient ``jax.grad`` takes through the JAX
    package's ``flat_conv3x3`` / ``flat_conv3d`` (its K4 ``dw_reduce``, and
    the 3D form's dots) on the same bf16 values, channels zero-padded to 32,
    within 1e-2 of the output's scale."""
    import jax
    import jax.numpy as jnp

    cin, cout = pair
    rng = _rng(8)
    shape = JAX_SHAPE if kd == 1 else (2, 5, 6, 16)
    x = _bf16_values(rng, (*shape, cin))
    g = _bf16_values(rng, (*shape, cout))
    xt, gt = (torch.from_numpy(a).bfloat16() for a in (x, g))
    got = dw_reduce(xt, gt) if kd == 1 else dw_reduce3d(xt, gt)
    taps = (3,) * (2 if kd == 1 else 3)
    wshape = taps + (cin, cout)
    assert got.dtype == torch.float32 and got.shape == wshape
    x32 = jnp.asarray(_pad32(x, [x.ndim - 1]), jnp.float32)
    g32 = jnp.asarray(_pad32(g, [g.ndim - 1]), jnp.float32)
    if kd == 1:
        def loss(w):
            return jnp.sum(_jax_flat_conv(x32, w) * g32)
    else:
        from realtime_stereo_matcher_tpu.kernels.train_conv3d import (
            flat_conv3d,
            vol_from_flat_batch,
            vol_to_flat_batch,
        )

        def loss(w):
            y = vol_from_flat_batch(flat_conv3d(vol_to_flat_batch(x32), w, 0),
                                    *shape, 32, phase=2)
            return jnp.sum(y * g32)
    want = jax.grad(loss)(jnp.zeros(taps + (32, 32), jnp.float32))
    want = np.asarray(want)[..., :cin, :cout]
    if kd == 1:
        want = want[None]
        got = got[None]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2 * scale)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tensor-core kernels run only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pair", NARROW)
@pytest.mark.parametrize("dilation", [1, 8])
def test_narrow_conv_on_cuda_matches_plain(cuda_device, pair, dilation):
    """The tensor-core K1 at a narrow pair against its plain version on a
    ragged batch, with and without a residual, within chip_smoke.py's
    TOL_BF16 (atol 2e-2, rtol 1e-2)."""
    from realtime_stereo_matcher_tpu_torch.kernels import _build

    cin, cout = pair
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=cuda_device) * 2 - 1

    scale, bias = rand(cout) * 0.5 + 1.0, rand(cout) * 0.3
    x = rand(3, 37, 53, cin).bfloat16()
    w = (rand(3, 3, cin, cout) / (3 * cin ** 0.5)).bfloat16()
    res = rand(3, 37, 53, cout).bfloat16()
    for act, r in ((PAIR_ACT[pair], None), ("relu", res)):
        before = _build.LAUNCHES["fused_conv3x3"]
        got = fused_conv3x3(x, w, scale, bias, dilation=dilation, act=act,
                            residual=r)
        assert _build.LAUNCHES["fused_conv3x3"] == before + 1
        want = fused_conv3x3_plain(x.float(), w.float(), scale, bias,
                                   dilation=dilation, act=act,
                                   residual=None if r is None else r.float())
        err = (got.float() - want).abs()
        assert bool((err <= 2e-2 + 1e-2 * want.abs()).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("kd,pair,dilation", [
    (kd, pair, d) for kd, pair in DW_NARROW for d in ((1, 8) if kd == 1
                                                      else (1,))])
def test_narrow_dw_on_cuda_matches_plain(cuda_device, kd, pair, dilation):
    """The tensor-core K4 at a narrow pair against its plain version on a
    ragged shape within chip_smoke.py's TOL_DW_BF16 (2e-2 of the output's
    scale, 1e-2 relative), and the same bits on a second launch."""
    cin, cout = pair
    shape = (3, 37, 53) if kd == 1 else (2, 5, 17, 33)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.rand((*shape, cin), generator=gen, device=cuda_device) * 2
         - 1).bfloat16()
    g = (torch.rand((*shape, cout), generator=gen, device=cuda_device) * 2
         - 1).bfloat16()
    if kd == 3:
        got, again = dw_reduce3d(x, g), dw_reduce3d(x, g)
        want = dw_reduce3d_plain(x.float(), g.float())
    else:
        got, again = dw_reduce(x, g, dilation), dw_reduce(x, g, dilation)
        want = dw_reduce_plain(x.float(), g.float(), dilation)
    scale = float(want.abs().max())
    assert bool(((got - want).abs() <= 2e-2 * scale + 1e-2 * want.abs())
                .all())
    assert torch.equal(got, again)
