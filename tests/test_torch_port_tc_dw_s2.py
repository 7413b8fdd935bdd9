"""The tile plans of the tensor-core K4 (``dw_reduce``, bf16 32 -> 32, 2D and
3D) and K2 (stride-2 conv, bf16 32 -> 32, 4x4 TF-SAME and 3x3), on the CPU.

Both kernels run only on the card (``csrc/dw_tc.cuh``, ``csrc/conv_s2_tc.cuh``;
``-m cuda`` here, where they skip).  Their tiling is computed in Python
(``dw_tc_plan``, ``conv_s2_tc_plan``) and checked again in C.  Here:

* the plans at every main-path shape and at ragged ones: each pixel of g is
  reduced by exactly one block and each output pixel stored by exactly one
  block (numpy coverage maps of the kernels' block mappings, restated);
  shared memory within the 232,448 B a block may opt in to on an H100, the
  grid's y and z within 65,535, and the plan's ring, shared memory, grid and
  workspace what the C entry points accept;
* a numpy emulation of each kernel's staging and fragment addressing (ring
  slots, the stacked rows of K4, K2's column-parity planes), with every
  staged slot NaN until a copy fills it: it agrees with the plain versions,
  so each step reads only rows its ring holds;
* ``frame_profile`` groups the new kernels;
* on CPU tensors the bf16 32 -> 32 wrappers run their plain versions, which
  agree with ``jax.grad`` of ``lax.conv_general_dilated`` (K4, within 1e-2
  of the output's scale) and with ``lax.conv_general_dilated`` (K2, within
  one bf16 ulp) on the same bf16 values.

JAX is imported inside the tests that use it, so that the file runs on the
card, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_tc_dw_s2.py
"""

import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu_torch.frame_profile import kernel_group
from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    GRID_YZ_MAX,
    Card,
    conv_s2_tc_plan,
    fused_conv3x3,
    fused_conv3x3_plain,
    fused_conv4x4_s2,
    fused_conv4x4_s2_plain,
    s2_ring,
)
from realtime_stereo_matcher_tpu_torch.kernels.train_conv import (
    DW_TC_OUT,
    dw_reduce,
    dw_reduce3d,
    dw_reduce3d_plain,
    dw_reduce_plain,
    dw_tc_plan,
)

H100 = Card(sms=132, smem_per_sm=233_472)
SMEM_MAX = 232_448

# (n, d, h, w, kd) of every bf16 32 -> 32 K4 launch: the v1 step (batch 4:
# refines at 480 x 640 to 120 x 160, encoder ResBlocks 240 x 320 to 60 x 80),
# the v2 / v3 step (batch 8: 240 x 320 to 60 x 80, encoder 30 x 40), the two
# cost-filter volumes; then ragged shapes (odd sizes, a width no strip
# divides, depths 5 and 7)
DW_SHAPES = ([(4, 1, 480 >> k, 640 >> k, 1) for k in range(4)]
             + [(8, 1, 240 >> k, 320 >> k, 1) for k in range(4)]
             + [(4, 24, 60, 80, 3), (8, 24, 30, 40, 3)]
             + [(3, 1, 37, 53, 1), (1, 1, 5, 130, 1), (2, 5, 17, 33, 3),
                (1, 7, 9, 21, 3)])
# (n, h, w, taps) of every bf16 32 -> 32 stride-2 launch: v1 / v2 encoder
# stages 2 and 3 (3x3), the v3 U-Net's three 4x4 downsamplers; then ragged
S2_SHAPES = ([(1, 720 >> k, 1280 >> k, 3) for k in (1, 2)]
             + [(1, 720 >> k, 1280 >> k, 4) for k in range(3)]
             + [(3, 37, 53, 4), (2, 38, 70, 4), (3, 37, 53, 3), (1, 9, 66, 3)])


def _rng(seed=0):
    return np.random.default_rng(seed)


def _bf16_values(rng, shape, scale=1.0):
    """float64 arrays of bf16-representable values."""
    a = torch.from_numpy((rng.uniform(-1, 1, shape) * scale)
                         .astype(np.float32)).bfloat16()
    return a.double().numpy()


# ---------------------------------------------------------------------------
# K4: the plan, and an emulation of csrc/dw_tc.cuh
# ---------------------------------------------------------------------------


def _dw_blocks(plan):
    """Per block, (bx, by, kz, x0, first g row, steps) as ``dw_tc_kernel``
    maps ``blockIdx`` (x = strip, y = row chunk, z = depth tap)."""
    n, d, h, w = plan.shape
    rows = n * d * h
    gx, gy, gz = plan.grid
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                r0 = by * plan.steps * plan.th
                n_steps = min(plan.steps, -(-(rows - r0) // plan.th))
                yield bx, by, bz if plan.kd == 3 else 1, bx * plan.tw, r0, \
                    n_steps


def emulate_dw(x, g, plan):
    """``dw_tc_kernel`` then ``dw_sum_kernel`` in float64: the same loads
    into a NaN-filled ring and g buffers, the same groups, skips and
    fragment addresses, the same partial layout and summation order.
    Returns dW (kd, 3, 3, 32, 32) and the count of reductions of each g
    pixel, by depth tap."""
    n, d, h, w = plan.shape
    rows, th, tw, ring, dil = n * d * h, plan.th, plan.tw, plan.ring, \
        plan.dilation
    X, G = x.reshape(rows, w, 32), g.reshape(rows, w, 32)
    up = tw + 2 * dil
    gx, gy, gz = plan.grid
    parts = np.full((gx * gy * plan.kd, 9, 32, 32), np.nan)
    hits = np.zeros((plan.kd, rows, w), np.int64)
    for bx, by, kz, x0, r0, n_steps in _dw_blocks(plan):
        xoff = (kz - 1) * h
        u0 = r0 + xoff - dil
        xs = np.full((ring * up, 32), np.nan)
        gs = np.full((2, th * tw, 32), np.nan)

        def load_x(lo, hi):
            for u in range(lo, hi + 1):
                for p in range(up):
                    ix = x0 - dil + p
                    ok = 0 <= u < rows and 0 <= ix < w
                    xs[((u - u0) % ring) * up + p] = X[u, ix] if ok else 0.0

        def load_step(s):
            load_x(u0 if s == 0 else u0 + s * th + 2 * dil,
                   u0 + s * th + th - 1 + 2 * dil)
            for r in range(th):
                for p in range(tw):
                    row, ix = r0 + s * th + r, x0 + p
                    gs[s & 1, r * tw + p] = (G[row, ix] if row < rows
                                             and ix < w else 0.0)

        acc = np.zeros((3, 3, 32, 32))
        load_step(0)
        for s in range(n_steps):
            if s + 1 < n_steps:
                load_step(s + 1)  # in flight while step s computes
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
                    # the stack row that slot holds: row + xoff + (ky - 1) d
                    assert (row + xoff + (ky - 1) * dil - u0) % ring \
                        == unit // up
                    for c0 in range(0, tw, 16):
                        if x0 + c0 >= w:
                            break
                        b = gs[s & 1, r * tw + c0:r * tw + c0 + 16]
                        for kx in range(3):
                            a = xs[unit + c0 + kx * dil:
                                   unit + c0 + kx * dil + 16]
                            acc[ky, kx] += a.T @ b
                        if ky == 1:
                            hits[kz if plan.kd == 3 else 0, row,
                                 x0 + c0:min(w, x0 + c0 + 16)] += 1
        p = by * gx + bx
        parts[p * plan.kd + (kz if plan.kd == 3 else 0)] = \
            acc.reshape(9, 32, 32)
    out = np.zeros((plan.kd * 9, 32, 32))
    for p in range(gx * gy):  # dw_sum_kernel: partials in order
        out += parts[p * plan.kd:(p + 1) * plan.kd].reshape(-1, 32, 32)
    return out.reshape(plan.kd, 3, 3, 32, 32), hits


def _dw_tap_rows_valid(plan):
    """Per depth tap, the g rows whose centre tap reads inside the volume
    (every row in 2D; in 3D the planes z with 0 <= z + kz - 1 < D)."""
    n, d, h, _ = plan.shape
    z = (np.arange(n * d * h) // h) % d
    if plan.kd == 1:
        return np.ones((1, n * d * h), bool)
    return np.stack([(z + kz - 1 >= 0) & (z + kz - 1 < d) for kz in range(3)])


@pytest.mark.parametrize("shape,dilation", [
    (s, dil) for s in DW_SHAPES for dil in ((1, 2, 4, 8) if s[4] == 1 else (1,))])
def test_dw_tc_plan_reduces_each_pixel_once(shape, dilation):
    n, d, h, w, kd = shape
    plan = dw_tc_plan(n, d, h, w, kd, dilation, H100)
    assert plan.kd == kd and plan.shape == (n, d, h, w)
    # what launch_dw_tc accepts: a staged x row of tw + 2 d pixels is at
    # most one 16-byte chunk for each of the 384 threads
    assert plan.th == 8 and plan.tw % 16 == 0 and plan.tw >= 16
    assert (plan.tw + 2 * dilation) * 4 <= 384
    assert plan.ring == 2 * plan.th + 2 * dilation
    stream = (plan.ring * (plan.tw + 2 * dilation) + 2 * 8 * plan.tw) * 64
    assert plan.smem == max(stream, 9 * 32 * 32 * 4) <= SMEM_MAX
    tiles = -(-(n * d * h) // 8)
    gx, gy, gz = plan.grid
    assert (gx, gy, gz) == (-(-w // plan.tw), -(-tiles // plan.steps), kd)
    assert 1 <= gy <= GRID_YZ_MAX and plan.steps >= 1
    assert plan.work_floats == gx * gy * gz * 9 * 32 * 32 == gx * gy * gz \
        * DW_TC_OUT
    # each g pixel in exactly one block (per depth tap), each block a
    # distinct partial
    hits = np.zeros((kd, n * d * h, w), np.int32)
    slots = []
    for bx, by, kz, x0, r0, n_steps in _dw_blocks(plan):
        assert n_steps >= 1
        hits[kz if kd == 3 else 0, r0:r0 + n_steps * 8, x0:x0 + plan.tw] += 1
        slots.append((by * gx + bx) * kd + (kz if kd == 3 else 0))
    np.testing.assert_array_equal(hits, 1)
    assert sorted(slots) == list(range(plan.work_floats // DW_TC_OUT))


def test_dw_tc_workspace_is_small_at_the_largest_launches():
    """About one partial an SM: the workspace is at most 10% of the bytes
    the largest 2D and 3D launches read (the CUDA-core kernel's was 13% and
    108%)."""
    for n, d, h, w, kd in [(4, 1, 480, 640, 1), (4, 24, 60, 80, 3)]:
        plan = dw_tc_plan(n, d, h, w, kd, 1, H100)
        assert plan.work_floats * 4 <= 0.1 * n * d * h * w * 32 * 2 * 2
        assert plan.grid[0] * plan.grid[1] * plan.grid[2] <= H100.sms


@pytest.mark.parametrize("shape,dilation", [
    ((2, 1, 19, 37, 1), 1), ((2, 1, 19, 37, 1), 2), ((1, 1, 21, 70, 1), 4),
    ((2, 1, 13, 29, 1), 8), ((2, 5, 9, 21, 3), 1), ((1, 3, 4, 17, 3), 1)])
def test_dw_tc_emulation_matches_plain(shape, dilation):
    """The kernel's loads, skips and fragment addresses, restated in numpy,
    give the plain dW; each g pixel is reduced once for each depth tap that
    reads inside the volume and never for one that does not."""
    n, d, h, w, kd = shape
    rng = _rng(1)
    x = rng.uniform(-1, 1, (n, d, h, w, 32))
    g = rng.uniform(-1, 1, (n, d, h, w, 32))
    # small steps so that the ring wraps and blocks share the stack
    plan = dw_tc_plan(n, d, h, w, kd, dilation,
                      Card(sms=4, smem_per_sm=233_472))
    got, hits = emulate_dw(x, g, plan)
    if kd == 1:
        want = dw_reduce_plain(torch.from_numpy(x[:, 0]),
                               torch.from_numpy(g[:, 0]), dilation)[None]
    else:
        want = dw_reduce3d_plain(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-9)
    valid = _dw_tap_rows_valid(plan)
    np.testing.assert_array_equal(hits, valid[:, :, None] * np.ones(w, int))


# ---------------------------------------------------------------------------
# K2: the plan, and an emulation of csrc/conv_s2_tc.cuh
# ---------------------------------------------------------------------------


def s2_parity_position(q, tw=32):
    """Where ``conv_s2_tc_kernel`` stages input column ``c0 + q`` of a ring
    row: plane ``q % 2`` (even columns, then odd), position ``q // 2``."""
    return (q % 2) * (tw + 2) + q // 2


def _s2_blocks(plan):
    gx, gy, gz = plan.grid
    ho = plan.out_hw[0]
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                oy0 = by * plan.steps * plan.th
                yield bz, bx * plan.tw, oy0, min(plan.steps,
                                                 -(-(ho - oy0) // plan.th))


def emulate_s2(x, w, plan):
    """``conv_s2_tc_kernel`` in float64 without the epilogue: the same
    parity-plane loads into a NaN-filled ring and the same A addresses.
    Returns the conv (n, ho, wo, 32) and how often each output was stored."""
    n, h, wd = plan.shape
    ho, wo = plan.out_hw
    kt, th, tw, ring = plan.taps, plan.th, plan.tw, plan.ring
    up = 2 * (tw + 2)
    out = np.full((n, ho, wo, 32), np.nan)
    stores = np.zeros((n, ho, wo), np.int64)
    for b, ox0, oy0, n_steps in _s2_blocks(plan):
        u0, c0 = 2 * oy0 - 1, 2 * ox0 - 2
        rs = np.full((ring * up, 32), np.nan)

        def load_rows(lo, hi):
            for u in range(lo, hi + 1):
                for q in range(up):
                    ok = 0 <= u < h and 0 <= c0 + q < wd
                    rs[((u - u0) % ring) * up + s2_parity_position(q, tw)] = \
                        x[b, u, c0 + q] if ok else 0.0

        def load_step(s):
            hi = u0 + 2 * s * th + 2 * th + kt - 3
            load_rows(u0 if s == 0 else hi - 2 * th + 1, hi)

        load_step(0)
        for s in range(n_steps):
            if s + 1 < n_steps:
                load_step(s + 1)
            for warp in range(8):
                oy = oy0 + s * th + warp
                if oy >= ho:
                    continue
                acc = np.zeros((tw, 32))
                for ky in range(kt):
                    unit = ((2 * oy - 1 + ky - u0) % ring) * up
                    for kx in range(kt):
                        pix = unit + ((kx + 1) & 1) * (tw + 2) + ((kx + 1) >> 1)
                        acc += rs[pix:pix + tw] @ w[ky, kx]
                cols = min(tw, wo - ox0)
                out[b, oy, ox0:ox0 + cols] = acc[:cols]
                stores[b, oy, ox0:ox0 + cols] += 1
    return out, stores


@pytest.mark.parametrize("shape", S2_SHAPES)
def test_s2_tc_plan_covers_each_output_once(shape):
    n, h, w, taps = shape
    plan = conv_s2_tc_plan(n, h, w, taps, H100)
    ho, wo = (h + 1) // 2, (w + 1) // 2
    assert plan.out_hw == (ho, wo) and plan.taps == taps
    # what launch_s2_tc accepts: an 8 x 32 tile, a ring of 4 * 8 + taps - 2
    # rows of 2 x 34 pixels, the weights, 8 KB of staging
    assert (plan.th, plan.tw) == (8, 32)
    assert plan.ring == 4 * 8 + taps - 2 == s2_ring(taps)
    assert plan.smem == (taps * taps * 32 * 64 + plan.ring * 68 * 64
                         + 8 * 16 * 64) <= SMEM_MAX
    tiles_h = -(-ho // 8)
    assert plan.grid == (-(-wo // 32), -(-tiles_h // plan.steps), n)
    assert plan.grid[1] <= GRID_YZ_MAX and plan.grid[2] <= GRID_YZ_MAX
    hits = np.zeros((n, ho, wo), np.int32)
    for b, ox0, oy0, n_steps in _s2_blocks(plan):
        assert n_steps >= 1
        hits[b, oy0:oy0 + n_steps * 8, ox0:ox0 + 32] += 1
    np.testing.assert_array_equal(hits, 1)


def test_s2_tc_plan_fills_the_card_at_720p():
    """The 720 x 1280 -> 360 x 640 launch runs in one wave of one block an
    SM, each block walking several steps (its ring overlaps loads and
    MMAs only from the second)."""
    plan = conv_s2_tc_plan(1, 720, 1280, 4, H100)
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert 66 < blocks <= 132 and plan.steps > 1


def test_parity_deinterleave_is_a_permutation():
    """Staged columns 0 .. 2 (tw + 2) - 1 fill both parity planes, each
    position once, and tap kx of output column i reads staged column
    2 i + kx + 1 (input column 2 (ox0 + i) + kx - 1)."""
    tw = 32
    pos = [s2_parity_position(q, tw) for q in range(2 * (tw + 2))]
    assert sorted(pos) == list(range(2 * (tw + 2)))
    for kx in range(4):
        for i in range(tw):
            q = 2 * i + kx + 1
            assert s2_parity_position(q, tw) == ((kx + 1) & 1) * (tw + 2) \
                + i + ((kx + 1) >> 1)


@pytest.mark.parametrize("shape", [(2, 19, 37, 4), (1, 38, 70, 4),
                                   (2, 19, 37, 3), (1, 20, 66, 3)])
def test_s2_tc_emulation_matches_plain(shape):
    n, h, wd, taps = shape
    rng = _rng(2)
    x = rng.uniform(-1, 1, (n, h, wd, 32))
    w = rng.uniform(-1, 1, (taps, taps, 32, 32))
    plan = conv_s2_tc_plan(n, h, wd, taps, Card(sms=2, smem_per_sm=233_472))
    got, stores = emulate_s2(x, w, plan)
    one, zero = torch.ones(32, dtype=torch.float64), torch.zeros(
        32, dtype=torch.float64)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if taps == 4:
        want = fused_conv4x4_s2_plain(xt, wt, one, zero, act="none")
    else:
        want = fused_conv3x3_plain(xt, wt, one, zero, stride=2, act="none")
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-9)
    np.testing.assert_array_equal(stores, 1)


# ---------------------------------------------------------------------------
# profiler groups, and the CPU wrappers against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,group", [
    ("void rsm::tc::dw_tc_kernel<1>(__nv_bfloat16 const*, ...)",
     "dw_reduce 32->32"),
    ("rsm::tc::dw_tc_kernel<(int)3>", "dw_reduce 3D 32->32"),
    ("void rsm::tc::conv_s2_tc_kernel<4>(__nv_bfloat16 const*, ...)",
     "fused_conv4x4_s2 32->32"),
    ("rsm::tc::conv_s2_tc_kernel<(int)3>", "fused_conv3x3_s2 32->32"),
    ("void (anonymous namespace)::dw_sum_kernel(float const*, float*, int, "
     "int)", "dw_reduce partial sums"),
    ("void rsm::tc::dw_tc_kernel<1, 32, 32>(__nv_bfloat16 const*, ...)",
     "dw_reduce 32->32"),
    ("void rsm::tc::dw_tc_kernel<1, 4, 32>(__nv_bfloat16 const*, ...)",
     "dw_reduce 4->32"),
    ("rsm::tc::dw_tc_kernel<(int)1, (int)7, (int)32>", "dw_reduce 7->32"),
    ("void rsm::tc::dw_tc_kernel<1, 32, 1>(__nv_bfloat16 const*, ...)",
     "dw_reduce 32->1"),
    ("void rsm::tc::dw_tc_kernel<3, 32, 1>(__nv_bfloat16 const*, ...)",
     "dw_reduce 3D 32->1"),
    ("void rsm::tc::conv_nin_tc_kernel<4>(__nv_bfloat16 const*, ...)",
     "fused_conv3x3 4->32"),
    ("rsm::tc::conv_nin_tc_kernel<(int)7>", "fused_conv3x3 7->32"),
    ("void rsm::tc::conv_nin_tc_kernel<3>(__nv_bfloat16 const*, ...)",
     "fused_conv3x3 3->32"),
    ("void rsm::tc::conv_nin_tc_kernel<1>(__nv_bfloat16 const*, ...)",
     "fused_conv3x3 1->32"),
    ("void rsm::tc::conv_nout_tc_kernel<1>(__nv_bfloat16 const*, ...)",
     "fused_conv3x3 32->1"),
    ("rsm::tc::conv_nout_tc_kernel<(int)4>", "fused_conv3x3 32->4"),
    ("void rsm::tc::conv_nout_tc_kernel<7>(__nv_bfloat16 const*, ...)",
     "fused_conv3x3 32->7"),
])
def test_frame_profile_groups_the_new_kernels(name, group):
    assert kernel_group(name) == group


@pytest.mark.parametrize("dilation", [1, 4, 8, None])
def test_bf16_dw_on_cpu_runs_plain_and_matches_jax(dilation):
    """bf16 32 -> 32 ``dw_reduce`` (``None``: ``dw_reduce3d``) on CPU tensors
    against ``jax.grad`` of ``lax.conv_general_dilated`` on the same bf16
    values, within 1e-2 of the output's scale."""
    import jax
    import jax.numpy as jnp

    rng = _rng(3)
    shape = (2, 5, 9, 21) if dilation is None else (2, 19, 37)
    x, g = _bf16_values(rng, (*shape, 32)), _bf16_values(rng, (*shape, 32))
    xt, gt = (torch.from_numpy(a).bfloat16() for a in (x, g))
    if dilation is None:
        got = dw_reduce3d(xt, gt)
        dims, pad, dil = ("NDHWC", "DHWIO", "NDHWC"), [(1, 1)] * 3, (1,) * 3
        wshape = (3, 3, 3, 32, 32)
    else:
        got = dw_reduce(xt, gt, dilation)
        dims = ("NHWC", "HWIO", "NHWC")
        pad, dil = [(dilation, dilation)] * 2, (dilation,) * 2
        wshape = (3, 3, 32, 32)
    assert got.dtype == torch.float32 and got.shape == wshape

    def conv(w):
        return jax.lax.conv_general_dilated(
            jnp.asarray(x, jnp.float32), w, (1,) * len(dil), pad,
            rhs_dilation=dil, dimension_numbers=dims,
            precision=jax.lax.Precision.HIGHEST)

    want = jax.grad(lambda w: jnp.sum(conv(w) * jnp.asarray(g, jnp.float32)))(
        jnp.zeros(wshape, jnp.float32))
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2 * scale)


@pytest.mark.parametrize("taps,shape", [(4, (2, 19, 37)), (4, (1, 20, 66)),
                                        (3, (2, 19, 37)), (3, (1, 20, 66))])
def test_bf16_s2_on_cpu_runs_plain_and_matches_jax(taps, shape):
    """bf16 32 -> 32 stride-2 convs on CPU tensors (4x4 TF-SAME with leaky
    0.2, 3x3 padding 1 with ReLU) against ``lax.conv_general_dilated`` on
    the same bf16 values, within one bf16 ulp of the output."""
    import jax
    import jax.numpy as jnp

    rng = _rng(4)
    x = _bf16_values(rng, (*shape, 32))
    w = _bf16_values(rng, (taps, taps, 32, 32), 1 / np.sqrt(taps * taps * 32))
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, 32).astype(np.float32)
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    h, wd = shape[1:]
    if taps == 4:
        got = fused_conv4x4_s2(xt, wt, st, bt, act=0.2)
        # TF-SAME at stride 2: pad_lo 1, pad_hi 1 (even) or 2 (odd)
        pad = [(1, 1 + n % 2) for n in (h, wd)]
    else:
        got = fused_conv3x3(xt, wt, st, bt, stride=2, act="relu")
        pad = [(1, 1), (1, 1)]
    assert got.dtype == torch.bfloat16
    assert got.shape == (shape[0], (h + 1) // 2, (wd + 1) // 2, 32)
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32), (2, 2), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    y = y * scale + bias
    y = (jnp.maximum(y, 0.0) + 0.2 * jnp.minimum(y, 0.0) if taps == 4
         else jnp.maximum(y, 0.0))
    y = np.asarray(y.astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), y, rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.parametrize("header,macro", [
    ("dw_tc.cuh", "RSM_TC_CUT_A"), ("dw_tc.cuh", "RSM_TC_CUT_MMA"),
    ("conv_s2_tc.cuh", "RSM_TC_CUT_A"), ("conv_s2_tc.cuh", "RSM_TC_CUT_MMA"),
    ("conv_s2_tc.cuh", "RSM_TC_CUT_STORE"),
    ("conv_narrow_tc.cuh", "RSM_TC_CUT_A"),
    ("conv_narrow_tc.cuh", "RSM_TC_CUT_MMA"),
    ("conv_narrow_tc.cuh", "RSM_TC_CUT_STORE")])
def test_cut_variants_reach_the_new_kernels(header, macro):
    """``tools/tc_compare.py variants`` defines its cut macros at the top of
    ``conv_tc.cuh``; the new kernels' headers include it first and guard
    their fragment loads, MMAs and stores with the same macros, which no
    build of the package defines."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "tc_compare", root / "tools" / "tc_compare.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert any(macro in (m or ()) for m in tool.VARIANTS.values())
    csrc = root / "realtime_stereo_matcher_tpu_torch" / "csrc"
    text = (csrc / header).read_text()
    assert f"#ifndef {macro}\n" in text
    assert text.index('#include "conv_tc.cuh"') < text.index(f"#ifndef {macro}")
    for src in csrc.iterdir():
        assert f"#define {macro}" not in src.read_text()


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
@pytest.mark.parametrize("shape,dilation", [((3, 1, 37, 53), 1),
                                            ((3, 1, 37, 53), 8),
                                            ((2, 5, 17, 33), None)])
def test_dw_tc_on_cuda_matches_plain(cuda_device, shape, dilation):
    """The tensor-core K4 against its plain version on ragged shapes within
    chip_smoke.py's TOL_DW_BF16 (2e-2 of the output's scale, 1e-2
    relative), and the same bits on a second launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, g = ((torch.rand((*shape, 32), generator=gen, device=cuda_device) * 2
             - 1).bfloat16() for _ in range(2))
    if dilation is None:
        got, again = dw_reduce3d(x, g), dw_reduce3d(x, g)
        want = dw_reduce3d_plain(x.float(), g.float())
    else:
        x, g = x[:, 0].contiguous(), g[:, 0].contiguous()
        got, again = dw_reduce(x, g, dilation), dw_reduce(x, g, dilation)
        want = dw_reduce_plain(x.float(), g.float(), dilation)
    scale = float(want.abs().max())
    assert bool(((got - want).abs() <= 2e-2 * scale + 1e-2 * want.abs())
                .all())
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [3, 4])
def test_s2_tc_on_cuda_matches_plain(cuda_device, taps):
    """The tensor-core stride-2 conv against its plain version on a ragged
    batch, within chip_smoke.py's TOL_BF16 (atol 2e-2, rtol 1e-2)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=cuda_device) * 2 - 1

    scale, bias = rand(32) * 0.5 + 1.0, rand(32) * 0.3
    x = rand(3, 37, 53, 32).bfloat16()
    w = (rand(taps, taps, 32, 32) / (taps * 6)).bfloat16()
    if taps == 4:
        got = fused_conv4x4_s2(x, w, scale, bias, act=0.2)
        want = fused_conv4x4_s2_plain(x.float(), w.float(), scale, bias,
                                      act=0.2)
    else:
        got = fused_conv3x3(x, w, scale, bias, stride=2)
        want = fused_conv3x3_plain(x.float(), w.float(), scale, bias,
                                   stride=2)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=1e-2)
