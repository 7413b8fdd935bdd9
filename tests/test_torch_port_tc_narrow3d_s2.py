"""The tensor-core kernels of K3's narrow pairs and K2's narrow stem, on the
CPU: ``fused_conv3d`` (bf16) at 32 -> 1 (the cost filter's head) and 1 -> 32
(its dx in training), ``csrc/conv3d_narrow_tc.cuh``, and ``fused_conv3x3``
(bf16, stride 2) at 3 -> 32 (the v1 / v2 encoders' stem),
``csrc/conv_s2_tc.cuh`` ``conv_s2_nin_tc_kernel``.

The kernels run only on the card (``-m cuda`` here, where those tests skip).
Here:

* their tile plans at the main-path shapes and at ragged ones: each output
  pixel is covered by exactly one block, shared memory fits the 232,448 B a
  block may opt in to on an H100, the grid fits, and the largest launch
  fills the card in one wave;
* a numpy emulation of each kernel as it stages and indexes its operands,
  every staged slot NaN until a copy fills it: K3's depth-slab ring, the
  head's N = (kx, co) partial columns summed shifted in the epilogue, the
  dx's 2-byte ring gathered per lane with the taps in K (27 padded to 32),
  K2's 8-byte staged pixels in column order with a kernel row to a k16
  step; A @ B gives ``fused_conv3d_plain`` / ``fused_conv3x3_plain`` on
  ragged shapes (odd H and W, D not a multiple of the chunk, several steps a
  block so that the rings wrap);
* on CPU tensors the bf16 wrappers run their plain versions, which agree
  with the JAX package on the same bf16 values within one bf16 ulp: the
  head with its ``flat_conv3d`` (the Pallas kernel K3, in interpret mode on
  the CPU) followed by the bias, the dx with ``jax.grad`` through the same
  function, the stem with ``fused_conv3x3_s2_flat`` (K2, in interpret mode)
  followed by the epilogue; channels zero-padded to 32 as the JAX flat
  layout needs;
* the profiler groups of the new kernels, and the cut macros of
  ``tools/tc_compare.py`` reaching them.

JAX is imported inside the tests that use it, so that the file runs on the
card, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_tc_narrow3d_s2.py
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu_torch.frame_profile import (
    kernel_group,
    kernel_route,
)
from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    GRID_YZ_MAX,
    Card,
    conv_s2_tc_plan,
    fused_conv3x3,
    fused_conv3x3_plain,
    tc_blocks_per_sm,
)
from realtime_stereo_matcher_tpu_torch.kernels.cost_filter3d import (
    conv3d_tc_plan,
    fused_conv3d,
    fused_conv3d_plain,
)
from realtime_stereo_matcher_tpu_torch.kernels.train_conv3d import flat_conv3d

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "realtime_stereo_matcher_tpu_torch" / "csrc"
H100 = Card(sms=132, smem_per_sm=233_472)
SMEM_MAX = 232_448
K3_PAIRS = [(32, 1), (1, 32)]
# (b, d, h, w): the 720p cost volume, the v1 and v2 / v3 training volumes,
# then ragged ones
K3_SHAPES = [(1, 24, 90, 160), (4, 24, 60, 80), (8, 24, 30, 40),
             (2, 5, 37, 53), (1, 7, 17, 33), (3, 2, 9, 70)]
# (n, h, w) of the stem: the 720p frame, then ragged
S2_SHAPES = [(1, 720, 1280), (3, 37, 53), (2, 38, 70), (1, 9, 66),
             (2, 181, 321)]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _bf16_values(rng, shape, scale=1.0):
    """float64 arrays of bf16-representable values."""
    a = torch.from_numpy((rng.uniform(-1, 1, shape) * scale)
                         .astype(np.float32)).bfloat16()
    return a.double().numpy()


# ---------------------------------------------------------------------------
# K3: plans, and emulations of csrc/conv3d_narrow_tc.cuh
# ---------------------------------------------------------------------------


def _k3_blocks(plan):
    """Per block, (n, x0, y0, z0, steps) as the kernels map ``blockIdx``."""
    _, d, _, w = plan.shape
    gx, gy, gz = plan.grid
    tiles_w = -(-w // plan.tw)
    for n in range(gz):
        for by in range(gy):
            for bx in range(gx):
                z0 = by * plan.steps
                yield (n, (bx % tiles_w) * plan.tw, (bx // tiles_w) * plan.th,
                       z0, min(plan.steps, d - z0))


@pytest.mark.parametrize("pair", K3_PAIRS)
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_narrow3d_plan_covers_each_voxel_once(pair, shape):
    b, d, h, w = shape
    cin, cout = pair
    plan = conv3d_tc_plan(b, d, h, w, H100, cin, cout)
    # what launch_conv3d_narrow_tc accepts: 16 x 32 tiles, a ring of 4 slabs
    # of 18 x 34 pixels; shared memory: the weights (288 rows of 16 B for
    # the head, 32 rows of 64 B for the dx), the slabs (64-byte or 2-byte
    # pixels) and 8 KB of staging
    assert (plan.kd, plan.th, plan.tw, plan.ring) == (3, 16, 32, 4)
    want = (288 * 16 + 4 * 612 * 64 if cin == 32 else
            32 * 64 + 4 * 612 * 2) + 8 * 1024
    assert plan.smem == want <= SMEM_MAX
    tiles = -(-h // 16) * -(-w // 32)
    assert plan.grid == (tiles, -(-d // plan.steps), b)
    assert plan.grid[1] <= GRID_YZ_MAX and plan.grid[2] <= GRID_YZ_MAX
    hits = np.zeros((b, d, h, w), np.int32)
    for n, x0, y0, z0, steps in _k3_blocks(plan):
        assert steps >= 1
        hits[n, z0:z0 + steps, y0:y0 + 16, x0:x0 + 32] += 1
    np.testing.assert_array_equal(hits, 1)


@pytest.mark.parametrize("pair,shape,per_sm", [
    ((32, 1), (1, 24, 90, 160), 1), ((1, 32), (4, 24, 60, 80), 2)])
def test_narrow3d_plan_fills_the_card(pair, shape, per_sm):
    """The largest launch of each pair (the head in every frame, its dx in
    the v1 step) runs one wave that fills >= 0.9 of the block slots: one
    block an SM for the head's 175 KB of slabs, two for the dx's 15 KB."""
    plan = conv3d_tc_plan(*shape, H100, *pair)
    assert tc_blocks_per_sm(plan.smem, H100) == per_sm
    slots = per_sm * H100.sms
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert 0.9 * slots <= blocks <= slots


def _slab(vol, n, u, y0, x0):
    """Slab u of the tile at (y0, x0): (612, C), input (u, y0 - 1 + p // 34,
    x0 - 1 + p % 34), zero outside the volume (the SAME padding)."""
    _, d, h, w, c = vol.shape
    out = np.zeros((18, 34, c))
    if 0 <= u < d:
        iy, ix = np.arange(y0 - 1, y0 + 17), np.arange(x0 - 1, x0 + 33)
        oky, okx = (iy >= 0) & (iy < h), (ix >= 0) & (ix < w)
        out[np.ix_(oky, okx)] = vol[n, u][np.ix_(iy[oky], ix[okx])]
    return out.reshape(612, c)


def emulate_conv3d_head(x, w, plan):
    """``conv3d_nout_tc_kernel`` in float64 without the epilogue: the same
    slab loads into a NaN-filled ring of 4 (slab u0 + s + 3 issued at the
    top of step s into the slot step s - 1 freed), the same staged weights
    (N = (kx, co) padded to 8) and A rows (M the 34 tiles of flat input
    columns r * 34 + c), the partial columns summed shifted.  Returns the
    conv (b, d, h, w, 1) and how often each output voxel was stored."""
    b, d, h, wd = plan.shape
    out = np.full((b, d, h, wd, 1), np.nan)
    stores = np.zeros((b, d, h, wd), np.int64)
    wst = np.zeros((9, 32, 8))  # row (dz * 3 + dy, ci), column kx
    wst[:, :, :3] = w[..., 0].reshape(9, 3, 32).transpose(0, 2, 1)
    r, j = np.divmod(np.arange(512), 32)  # output pixel (row, column) order
    for n, x0, y0, z0, n_steps in _k3_blocks(plan):
        u0 = z0 - 1
        ring = np.full((4, 612, 32), np.nan)
        for i in range(3):
            ring[i] = _slab(x, n, u0 + i, y0, x0)
        for s in range(n_steps):
            if s + 1 < n_steps:
                ring[(s + 3) & 3] = _slab(x, n, u0 + s + 3, y0, x0)
            part = np.zeros((34 * 16, 8))
            for t in range(34):
                q = t * 16 + np.arange(16)
                for dz in range(3):
                    for dy in range(3):
                        part[q] += (ring[(s + dz) & 3][q + 34 * dy]
                                    @ wst[dz * 3 + dy])
            q = r * 34 + j
            v = part[q, 0] + part[q + 1, 1] + part[q + 2, 2]
            oy, ox = y0 + r, x0 + j
            ok = (oy < h) & (ox < wd)
            out[n, z0 + s, oy[ok], ox[ok], 0] = v[ok]
            stores[n, z0 + s, oy[ok], ox[ok]] += 1
    return out, stores


def _dx_lane_taps():
    """For each lane (32), k16 step, k half h, row half rr and pair element
    e: the A row, k, depth slab dz and offset dy * 34 + kx the kernel reads
    (the padded taps 27-31 at tap 26's pixel)."""
    rows, ks_, ks, dzs, offs = [], [], [], [], []
    for lane in range(32):
        for s in range(2):
            for hh in range(2):
                for rr in range(2):
                    for e in range(2):
                        k = s * 16 + 8 * hh + 2 * (lane & 3) + e
                        t = min(k, 26)
                        rows.append((lane >> 2) + 8 * rr)
                        ks_.append(s)
                        ks.append(k)
                        dzs.append(t // 9)
                        offs.append(((t % 9) // 3) * 34 + t % 3)
    return tuple(np.array(a) for a in (rows, ks, dzs, offs))


def emulate_conv3d_dx(g, w, plan):
    """``conv3d_nin_tc_kernel`` in float64 without the epilogue: a
    NaN-filled ring of 4 slabs of scalar (2-byte) pixels, the first three
    stored at once and slab u0 + s + 3 stored after step s's MMAs; each
    lane's A values gathered at its own taps' offsets (K = 27 taps padded
    to 32) against the 32 staged weight rows (27-31 zero).  Returns the
    conv (b, d, h, w, 32) and how often each output voxel was stored."""
    b, d, h, wd = plan.shape
    out = np.full((b, d, h, wd, 32), np.nan)
    stores = np.zeros((b, d, h, wd), np.int64)
    wst = np.zeros((32, 32))
    wst[:27] = w.reshape(27, 32)
    rows, ks, dzs, offs = _dx_lane_taps()
    for n, x0, y0, z0, n_steps in _k3_blocks(plan):
        u0 = z0 - 1
        ring = np.full((4, 612), np.nan)
        for i in range(3):
            ring[i] = _slab(g, n, u0 + i, y0, x0)[:, 0]
        for s in range(n_steps):
            pre = _slab(g, n, u0 + s + 3, y0, x0)[:, 0] \
                if s + 1 < n_steps else None
            flat = ring.reshape(-1)
            for warp in range(8):
                for m in range(4):
                    r, c = warp * 2 + (m >> 1), (m & 1) * 16
                    a = np.zeros((16, 32))
                    a[rows, ks] = flat[((s + dzs) & 3) * 612 + offs
                                       + r * 34 + c + rows]
                    acc = a @ wst
                    oy, ox = y0 + r, x0 + c
                    valid = min(16, wd - ox) if oy < h else 0
                    if valid > 0:
                        out[n, z0 + s, oy, ox:ox + valid] = acc[:valid]
                        stores[n, z0 + s, oy, ox:ox + valid] += 1
            if pre is not None:
                ring[(s + 3) & 3] = pre
    return out, stores


def _small_card_plan(shape, pair):
    """A plan on a card of 1 SM: several depths a block, so the rings
    wrap."""
    plan = conv3d_tc_plan(*shape, Card(1, 233_472), *pair)
    assert plan.steps > 3
    return plan


@pytest.mark.parametrize("shape", [(2, 7, 19, 37), (1, 9, 17, 70),
                                   (1, 6, 33, 31)])
def test_head_emulation_matches_plain(shape):
    """The 32 -> 1 head as the kernel stages and indexes it is the plain
    conv; each output voxel is stored once."""
    rng = _rng(1)
    x = rng.uniform(-1, 1, (*shape, 32))
    w = rng.uniform(-1, 1, (3, 3, 3, 32, 1))
    got, stores = emulate_conv3d_head(x, w, _small_card_plan(shape, (32, 1)))
    one, zero = (torch.ones(1, dtype=torch.float64),
                 torch.zeros(1, dtype=torch.float64))
    want = fused_conv3d_plain(torch.from_numpy(x), torch.from_numpy(w), one,
                              zero, relu=False)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-9)
    np.testing.assert_array_equal(stores, 1)


@pytest.mark.parametrize("shape", [(2, 7, 19, 37), (1, 9, 17, 70)])
def test_dx_emulation_matches_plain(shape):
    """The 1 -> 32 dx as the kernel stages and gathers it is the plain
    conv; each output voxel is stored once."""
    rng = _rng(2)
    g = rng.uniform(-1, 1, (*shape, 1))
    w = rng.uniform(-1, 1, (3, 3, 3, 1, 32))
    got, stores = emulate_conv3d_dx(g, w, _small_card_plan(shape, (1, 32)))
    one, zero = (torch.ones(32, dtype=torch.float64),
                 torch.zeros(32, dtype=torch.float64))
    want = fused_conv3d_plain(torch.from_numpy(g), torch.from_numpy(w), one,
                              zero, relu=False)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-9)
    np.testing.assert_array_equal(stores, 1)


def test_dx_taps_cover_k_once():
    """The lanes' A fragment entries cover each (row, k) of the 16 x 32 A
    matrix exactly once, taps 0-26 at their own offsets."""
    rows, ks, dzs, offs = _dx_lane_taps()
    cells = rows * 32 + ks
    assert sorted(cells) == list(range(16 * 32))
    for k, dz, off in zip(ks, dzs, offs):
        if k < 27:
            assert (dz, off) == (k // 9, ((k % 9) // 3) * 34 + k % 3)


# ---------------------------------------------------------------------------
# K2 3 -> 32: plan, and an emulation of conv_s2_nin_tc_kernel
# ---------------------------------------------------------------------------


def _s2_blocks(plan):
    """Per block, (n, ox0, oy0, steps) as the kernels map ``blockIdx``."""
    ho = plan.out_hw[0]
    gx, gy, gz = plan.grid
    for n in range(gz):
        for by in range(gy):
            for bx in range(gx):
                oy0 = by * plan.steps * plan.th
                yield n, bx * plan.tw, oy0, min(plan.steps,
                                                -(-(ho - oy0) // plan.th))


@pytest.mark.parametrize("shape", S2_SHAPES)
def test_stem_plan_covers_each_output_once(shape):
    n, h, w = shape
    plan = conv_s2_tc_plan(n, h, w, 3, H100, 3)
    ho, wo = (h + 1) // 2, (w + 1) // 2
    assert plan.out_hw == (ho, wo) and plan.taps == 3
    # what launch_s2_tc accepts at 3 -> 32: an 8 x 32 tile, a ring of 33
    # input rows of 66 staged 8-byte pixels, 48 weight rows of 64 B, 8 KB
    # of staging
    assert (plan.th, plan.tw, plan.ring) == (8, 32, 33)
    assert plan.smem == 48 * 64 + 33 * 66 * 8 + 8 * 1024 <= SMEM_MAX
    tiles_h = -(-ho // 8)
    assert plan.grid == (-(-wo // 32), -(-tiles_h // plan.steps), n)
    assert plan.grid[1] <= GRID_YZ_MAX and plan.grid[2] <= GRID_YZ_MAX
    hits = np.zeros((n, ho, wo), np.int32)
    for b, ox0, oy0, steps in _s2_blocks(plan):
        assert steps >= 1
        hits[b, oy0:oy0 + steps * 8, ox0:ox0 + 32] += 1
    np.testing.assert_array_equal(hits, 1)


def test_stem_plan_fills_the_card_at_720p():
    """The 720 x 1280 -> 360 x 640 stem runs one wave of two blocks an SM
    (the most a plan counts), >= 0.9 of the slots, each block walking
    several steps."""
    plan = conv_s2_tc_plan(1, 720, 1280, 3, H100, 3)
    assert tc_blocks_per_sm(plan.smem, H100) == 2
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert 0.9 * 2 * H100.sms <= blocks <= 2 * H100.sms and plan.steps > 1


def test_stem_plan_refuses_other_pairs():
    with pytest.raises(ValueError):
        conv_s2_tc_plan(1, 64, 64, 4, H100, 3)
    with pytest.raises(ValueError):
        conv_s2_tc_plan(1, 64, 64, 3, H100, 4)


def emulate_s2_stem(x, w, plan):
    """``conv_s2_nin_tc_kernel`` in float64 without the epilogue: input rows
    staged in column order as 8-byte pixels (3 channels padded to 4; pixel
    p of a row is input column 2 ox0 - 1 + p) into a NaN-filled ring of 33
    rows, the first step's 17 at once and the next step's 16 stored after a
    step's MMAs; 48 weight rows (ky * 16 + kx * 4 + ci, zero at kx = 3);
    per row tap one A fragment whose lanes 0-15 read the 16-byte row at
    staged pixel 2 i (kx 0, 1) and lanes 16-31 the row at 2 i + 2 (kx 2,
    then the next column's pixel, zeroed in the registers).  Returns the
    conv (n, ho, wo, 32) and how often each output pixel was stored."""
    n_, h, wd, cin = x.shape
    ho, wo = plan.out_hw
    ring_rows, cols, tw = plan.ring, 2 * plan.tw + 2, plan.tw
    wst = np.zeros((3, 16, 32))
    for ky in range(3):
        for kx in range(3):
            wst[ky, kx * 4:kx * 4 + cin] = w[ky, kx]
    out = np.full((n_, ho, wo, 32), np.nan)
    stores = np.zeros((n_, ho, wo), np.int64)
    i16 = np.arange(16)
    for n, ox0, oy0, n_steps in _s2_blocks(plan):
        u0, c0 = 2 * oy0 - 1, 2 * ox0 - 1
        ring = np.full((ring_rows * cols, 4), np.nan)

        def load(lo, rows):
            i = np.arange(rows * cols)
            u, ix = lo + i // cols, c0 + i % cols
            ok = (u >= 0) & (u < h) & (ix >= 0) & (ix < wd)
            v = np.zeros((i.size, 4))
            v[ok, :cin] = x[n, u[ok], ix[ok]]
            ring[((u - u0) % ring_rows) * cols + i % cols] = v

        load(u0, 17)
        for s in range(n_steps):
            for warp in range(8):
                oy = oy0 + s * 8 + warp
                if oy >= ho:
                    continue
                for m in range(2):
                    acc = np.zeros((16, 32))
                    for ky in range(3):
                        base = ((2 * oy - 1 + ky - u0) % ring_rows) * cols \
                            + 2 * (m * 16 + i16)
                        a = np.concatenate(
                            [ring[base], ring[base + 1], ring[base + 2],
                             ring[base + 3]], axis=1)
                        a[:, 12:] = 0.0  # zeroed in the registers
                        acc += a @ wst[ky]
                    ox = ox0 + m * 16
                    valid = min(16, wo - ox)
                    if valid > 0:
                        out[n, oy, ox:ox + valid] = acc[:valid]
                        stores[n, oy, ox:ox + valid] += 1
            if s + 1 < n_steps:
                load(u0 + 16 * (s + 1) + 1, 16)
    return out, stores


@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 38, 70), (1, 75, 66)])
def test_stem_emulation_matches_plain(shape):
    """The 3 -> 32 stem as the kernel stages and indexes it is the plain
    stride-2 conv (torch padding 1, ceil sizes); each output pixel is
    stored once."""
    rng = _rng(3)
    x = rng.uniform(-1, 1, (*shape, 3))
    w = rng.uniform(-1, 1, (3, 3, 3, 32))
    # a card of 1 SM: several steps a block, so the ring wraps
    plan = conv_s2_tc_plan(*shape, 3, Card(1, 233_472), 3)
    assert plan.steps > 1
    got, stores = emulate_s2_stem(x, w, plan)
    one, zero = (torch.ones(32, dtype=torch.float64),
                 torch.zeros(32, dtype=torch.float64))
    want = fused_conv3x3_plain(torch.from_numpy(x), torch.from_numpy(w), one,
                               zero, stride=2, act="none")
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-9)
    np.testing.assert_array_equal(stores, 1)


# ---------------------------------------------------------------------------
# profiler groups and cut variants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,group", [
    ("void rsm::tc::conv3d_nout_tc_kernel(__nv_bfloat16 const*, ...)",
     "fused_conv3d 32->1"),
    ("rsm::tc::conv3d_nout_tc_kernel", "fused_conv3d 32->1"),
    ("void rsm::tc::conv3d_nin_tc_kernel(__nv_bfloat16 const*, ...)",
     "fused_conv3d 1->32"),
    ("void rsm::tc::conv_s2_nin_tc_kernel<3>(__nv_bfloat16 const*, ...)",
     "fused_conv3x3_s2 3->32"),
    ("rsm::tc::conv_s2_nin_tc_kernel<(int)3>", "fused_conv3x3_s2 3->32"),
    # the 32 -> 32 stride-2 and 3x3x3 kernels keep their groups
    ("void rsm::tc::conv_s2_tc_kernel<3>(__nv_bfloat16 const*, ...)",
     "fused_conv3x3_s2 32->32"),
    ("void rsm::tc::conv_tc_kernel<3>(__nv_bfloat16 const*, ...)",
     "fused_conv3d 32->32"),
])
def test_frame_profile_groups_the_narrow3d_s2_kernels(name, group):
    assert kernel_group(name) == group
    assert kernel_route(name) == "tensor cores"


def test_frame_profile_keeps_float32_narrow_pairs_on_the_cuda_cores():
    for name, group in (
            ("void rsm::conv_kernel<float, 32, 1, 1, 3, 3>(...)",
             "fused_conv3d 32->1"),
            ("void rsm::conv_kernel<float, 3, 32, 2, 1, 3>(...)",
             "fused_conv3x3_s2 3->32")):
        assert kernel_group(name) == group
        assert kernel_route(name) == "cuda cores"


def _tc_compare():
    spec = importlib.util.spec_from_file_location(
        "tc_compare", ROOT / "tools" / "tc_compare.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("macro", ["RSM_TC_CUT_A", "RSM_TC_CUT_MMA",
                                   "RSM_TC_CUT_STORE"])
def test_cut_variants_reach_the_narrow3d_kernels(macro):
    """``tools/tc_compare.py variants`` defines its cut macros at the top of
    ``conv_tc.cuh``, which ``conv3d_narrow_tc.cuh`` includes first; the
    header guards its fragment loads, MMAs and stores with each, and no
    build of the package defines one."""
    tool = _tc_compare()
    assert any(macro in (m or ()) for m in tool.VARIANTS.values())
    text = (CSRC / "conv3d_narrow_tc.cuh").read_text()
    assert f"#ifndef {macro}\n" in text
    assert text.index('#include "conv_tc.cuh"') < text.index(f"#ifndef {macro}")
    for src in CSRC.iterdir():
        assert f"#define {macro}" not in src.read_text()


# ---------------------------------------------------------------------------
# the CPU wrappers against the JAX package's kernels
# ---------------------------------------------------------------------------

# (b, d, h, w) for K3's flat volume layout (w a multiple of 4)
JAX_VOL = (2, 5, 7, 16)


def _jax_flat_conv3d(x32, w32):
    """The JAX package's ``flat_conv3d`` on (B, D, H, W, 32) float32 values,
    through its batched flat volume layout, back to (B, D, H, W, 32)."""
    from realtime_stereo_matcher_tpu.kernels.train_conv3d import (
        flat_conv3d as jax_flat_conv3d,
        vol_from_flat_batch,
        vol_to_flat_batch,
    )

    return vol_from_flat_batch(
        jax_flat_conv3d(vol_to_flat_batch(x32), w32, 0), *x32.shape[:4], 32,
        phase=2)


def _pad32(a, axes):
    pad = [(0, 0)] * a.ndim
    for ax in axes:
        pad[ax] = (0, 32 - a.shape[ax])
    return np.pad(a, pad)


def _bf16_round(a):
    return torch.from_numpy(np.array(a, np.float32)).bfloat16().float() \
        .numpy()


def test_bf16_head_on_cpu_runs_plain_and_matches_jax():
    """bf16 ``fused_conv3d`` 32 -> 1 on CPU tensors (the head's epilogue:
    bias, no ReLU) against the JAX package's ``flat_conv3d`` (K3 in
    interpret mode) on the same bf16 values, C_out zero-padded to 32, then
    the bias and a bf16 cast: within one bf16 ulp."""
    import jax.numpy as jnp

    from realtime_stereo_matcher_tpu_torch.kernels import LAUNCHES

    rng = _rng(4)
    x = _bf16_values(rng, (*JAX_VOL, 32))
    w = _bf16_values(rng, (3, 3, 3, 32, 1), 1 / np.sqrt(27 * 32))
    scale = np.ones(1, np.float32)
    bias = rng.uniform(-0.3, 0.3, 1).astype(np.float32)
    before = sum(LAUNCHES.values())
    got = fused_conv3d(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(w).bfloat16(),
                       torch.from_numpy(scale), torch.from_numpy(bias),
                       relu=False)
    assert sum(LAUNCHES.values()) == before
    assert got.dtype == torch.bfloat16 and got.shape == (*JAX_VOL, 1)
    y = _jax_flat_conv3d(jnp.asarray(x, jnp.float32),
                         jnp.asarray(_pad32(w, [4]), jnp.float32))
    y = _bf16_round(np.asarray(y)[..., :1] * scale + bias)
    np.testing.assert_allclose(got.float().numpy(), y, rtol=2 ** -7,
                               atol=1e-5)


def test_bf16_head_dx_on_cpu_runs_plain_and_matches_jax_grad():
    """The dx of the head through the port's ``flat_conv3d`` on bf16 CPU
    tensors (K3 1 -> 32 on the cotangent, its plain version here) against
    the gradient ``jax.grad`` takes through the JAX package's
    ``flat_conv3d`` (its backward is K3 on the cotangent too) on the same
    bf16 values, C_out and the cotangent zero-padded to 32: within one bf16
    ulp of the float32 gradient."""
    import jax
    import jax.numpy as jnp

    rng = _rng(5)
    x = _bf16_values(rng, (*JAX_VOL, 32))
    w = _bf16_values(rng, (3, 3, 3, 32, 1), 1 / np.sqrt(27 * 32))
    g = _bf16_values(rng, (*JAX_VOL, 1))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).float()
    (dx,) = torch.autograd.grad(
        (flat_conv3d(xt, wt).float() * torch.from_numpy(g).float()).sum(),
        (xt,))
    assert dx.dtype == torch.bfloat16 and dx.shape == (*JAX_VOL, 32)
    w32 = jnp.asarray(_pad32(w, [4]), jnp.float32)
    g32 = jnp.asarray(_pad32(g, [4]), jnp.float32)
    want = jax.grad(lambda v: jnp.sum(_jax_flat_conv3d(v, w32) * g32))(
        jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(dx.float().numpy(), _bf16_round(want),
                               rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("hw", [(18, 64), (8, 128)])
def test_bf16_stem_on_cpu_runs_plain_and_matches_jax(hw):
    """bf16 ``fused_conv3x3`` 3 -> 32 at stride 2 on CPU tensors (the
    encoder stem's folded BN and ReLU) against the JAX package's
    ``fused_conv3x3_s2_flat`` (K2, in interpret mode on the CPU, as its own
    tests run it) on the same bf16 values, C_in zero-padded to 32 by its
    flat layout, then the bf16 cast: within one bf16 ulp."""
    import jax.numpy as jnp

    from realtime_stereo_matcher_tpu.kernels.conv3x3 import (
        fold_conv3x3_s2_weights,
        from_flat,
        fused_conv3x3_s2_flat,
        to_flat,
    )

    rng = _rng(6)
    h, wd = hw
    x = _bf16_values(rng, (1, h, wd, 3))
    w = _bf16_values(rng, (3, 3, 3, 32), 1 / np.sqrt(27))
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, 32).astype(np.float32)
    got = fused_conv3x3(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(w).bfloat16(),
                        torch.from_numpy(scale), torch.from_numpy(bias),
                        stride=2, act="relu")
    assert got.dtype == torch.bfloat16 and got.shape == (1, h // 2, wd // 2,
                                                         32)
    yf = fused_conv3x3_s2_flat(
        to_flat(jnp.asarray(x, jnp.float32), c_pad=32),
        fold_conv3x3_s2_weights(jnp.asarray(w, jnp.float32), c_in_pad=32,
                                c_out_pad=32),
        jnp.tile(jnp.asarray(scale), 4), jnp.tile(jnp.asarray(bias), 4),
        relu=True, th=8)
    y = np.asarray(from_flat(yf, h // 2, wd // 2, 32, 32))
    np.testing.assert_allclose(got.float().numpy(), _bf16_round(y),
                               rtol=2 ** -7, atol=1e-5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tensor-core kernels run only "
                    "on the card")
    return torch.device("cuda")


def _cuda_rand(gen, device, *shape):
    return torch.rand(shape, generator=gen, device=device) * 2 - 1


@pytest.mark.cuda
@pytest.mark.parametrize("pair", K3_PAIRS)
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_narrow3d_on_cuda_matches_plain(cuda_device, pair, shape):
    """The tensor-core K3 at 32 -> 1 (with its bias, and with ReLU) and
    1 -> 32 against the plain version, within chip_smoke.py's TOL_BF16
    (atol 2e-2, rtol 1e-2), one launch each."""
    from realtime_stereo_matcher_tpu_torch.kernels import _build

    cin, cout = pair
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = _cuda_rand(gen, cuda_device, *shape, cin).bfloat16()
    w = (_cuda_rand(gen, cuda_device, 3, 3, 3, cin, cout)
         / (5 * cin ** 0.5)).bfloat16()
    scale = _cuda_rand(gen, cuda_device, cout) * 0.5 + 1.0
    bias = _cuda_rand(gen, cuda_device, cout) * 0.3
    for relu in (False, True):
        before = _build.LAUNCHES["fused_conv3d"]
        got = fused_conv3d(x, w, scale, bias, relu=relu)
        assert _build.LAUNCHES["fused_conv3d"] == before + 1
        want = fused_conv3d_plain(x.float(), w.float(), scale, bias,
                                  relu=relu)
        err = (got.float() - want).abs()
        assert bool((err <= 2e-2 + 1e-2 * want.abs()).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", S2_SHAPES)
def test_stem_on_cuda_matches_plain(cuda_device, shape):
    """The tensor-core K2 at 3 -> 32 against the plain version, ReLU and
    leaky, within chip_smoke.py's TOL_BF16, one launch each; a residual is
    refused (the stride-2 kernels take none)."""
    from realtime_stereo_matcher_tpu_torch.kernels import _build

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = _cuda_rand(gen, cuda_device, *shape, 3).bfloat16()
    w = (_cuda_rand(gen, cuda_device, 3, 3, 3, 32) / 5).bfloat16()
    scale = _cuda_rand(gen, cuda_device, 32) * 0.5 + 1.0
    bias = _cuda_rand(gen, cuda_device, 32) * 0.3
    for act in ("relu", 0.2):
        before = _build.LAUNCHES["fused_conv3x3_s2"]
        got = fused_conv3x3(x, w, scale, bias, stride=2, act=act)
        assert _build.LAUNCHES["fused_conv3x3_s2"] == before + 1
        want = fused_conv3x3_plain(x.float(), w.float(), scale, bias,
                                   stride=2, act=act)
        err = (got.float() - want).abs()
        assert bool((err <= 2e-2 + 1e-2 * want.abs()).all()), float(err.max())
    with pytest.raises(ValueError):
        fused_conv3x3(x, w, scale, bias, stride=2, residual=torch.zeros_like(
            got))
