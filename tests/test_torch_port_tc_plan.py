"""The tile plans of the port's tensor-core convolutions, on the CPU.

The bf16 32 -> 32 stride-1 3x3 conv (K1) and the bf16 32 -> 32 3x3x3 conv
(K3) run on the card as the implicit-GEMM kernel of ``csrc/conv_tc.cuh``.
Its tiling is computed in Python (``conv3x3_tc_plan``,
``conv3d_tc_plan``) and checked again by the C entry point.  Here, at every
shape of the main paths and at ragged ones:

* every output pixel is stored by exactly one block (a numpy coverage map
  of the kernel's block mapping, restated here); also at the shapes of
  evaluation (320 x 448, the held-out synthetic scenes, and KITTI's frames
  padded to 384 x 1280, each level of the frame) for K1 at 32 -> 32 and
  its narrow pairs, K2 (3x3 32 -> 32 and 3 -> 32, 4x4 32 -> 32) and K3
  (32 -> 32, 32 -> 1, 1 -> 32);
* a block's dynamic shared memory stays within the 227 KB (232,448 B) a
  block may opt in to on an H100 SXM (132 SMs of 228 KB), and the grid's y
  and z within 65,535;
* the plan's ring, shared-memory bytes and grid are those ``launch_tc``
  accepts (the same formulas, restated from the kernel's layout);
* ``frame_profile`` groups the new kernels as ``fused_conv3x3 32->32`` and
  ``fused_conv3d 32->32``;
* on CPU tensors the wrappers still run the plain versions for bf16
  32 -> 32, which agree with ``jax.lax.conv_general_dilated`` on the same
  bf16 values within one bf16 ulp of the output.

The kernels themselves run only on the card (``-m cuda``; here they skip).
JAX is imported inside the tests that use it, so that the file runs on the
card, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_tc_plan.py
"""

import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu_torch.frame_profile import kernel_group
from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    GRID_YZ_MAX,
    TC_NARROW,
    Card,
    conv3x3_tc_plan,
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

# (n, h, w) of every 32 -> 32 stride-1 3x3 launch: the 720p inference
# levels (full to 1/8), the v1 training levels (batch 4 at 480 x 640) and
# the v2 / v3 ones (batch 8 at 240 x 320); then ragged shapes
K1_SHAPES = ([(1, 720 >> k, 1280 >> k) for k in range(4)]
             + [(4, 480 >> k, 640 >> k) for k in range(4)]
             + [(8, 240 >> k, 320 >> k) for k in range(4)]
             + [(3, 37, 53), (1, 5, 130)])
# (b, d, h, w) of the cost filter's 32 -> 32 layers: 720p inference, v1
# training, v2 / v3 training; then ragged volumes
K3_SHAPES = [(1, 24, 90, 160), (4, 24, 60, 80), (8, 24, 30, 40),
             (1, 5, 37, 53), (2, 7, 17, 33)]
# the card of the main paths: an H100 SXM
H100 = Card(sms=132, smem_per_sm=233_472)


def _regions(plan):
    """Per block, the output (n, depths, rows, columns) ranges it stores, as
    ``conv_tc_kernel`` maps ``blockIdx`` to its tiles (KD = 1: x = column
    strip, y = chunk of ``steps`` row tiles; KD = 3: x = (h, w) tile with w
    fastest, y = chunk of ``steps`` depths; z = batch) and masks the ragged
    edge."""
    n, d, h, w = plan.shape
    gx, gy, gz = plan.grid
    tiles_w = -(-w // plan.tw)
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                if plan.kd == 1:
                    y0, x0 = by * plan.steps * plan.th, bx * plan.tw
                    yield (bz, 0, 1, y0, min(h, y0 + plan.steps * plan.th),
                           x0, min(w, x0 + plan.tw))
                else:
                    y0 = (bx // tiles_w) * plan.th
                    x0 = (bx % tiles_w) * plan.tw
                    z0 = by * plan.steps
                    yield (bz, z0, min(d, z0 + plan.steps), y0,
                           min(h, y0 + plan.th), x0, min(w, x0 + plan.tw))


def _coverage(plan):
    n, d, h, w = plan.shape
    hits = np.zeros((n, d, h, w), np.int32)
    for b, z0, z1, y0, y1, x0, x1 in _regions(plan):
        hits[b, z0:z1, y0:y1, x0:x1] += 1
    return hits


def _check_limits(plan):
    assert plan.smem <= H100.smem_per_block == 232_448
    assert tc_blocks_per_sm(plan.smem, H100) >= 1
    gx, gy, gz = plan.grid
    assert 1 <= gx < 2 ** 31 and 1 <= gy <= GRID_YZ_MAX
    assert 1 <= gz <= GRID_YZ_MAX
    assert plan.steps >= 1


@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_conv3x3_tc_plan_covers_each_pixel_once(shape, dilation):
    n, h, w = shape
    plan = conv3x3_tc_plan(n, h, w, dilation, H100)
    assert plan.kd == 1 and plan.shape == (n, 1, h, w)
    _check_limits(plan)
    np.testing.assert_array_equal(_coverage(plan), 1)
    # what launch_tc<1> accepts: an 8 x 64 tile, a ring of 2 * 8 + 2 d
    # input rows of 64 + 2 d pixels, 18 KB of weights and 8 KB of staging
    th, tw = plan.th, plan.tw
    assert (th, tw) == (8, 64)
    assert plan.ring == 2 * th + 2 * dilation
    assert plan.smem == (9 * 32 * 64 + plan.ring * (tw + 2 * dilation) * 64
                         + 8 * 16 * 64)
    tiles_h = -(-h // th)
    assert plan.grid == (-(-w // tw), -(-tiles_h // plan.steps), n)


@pytest.mark.parametrize("shape", K3_SHAPES)
def test_conv3d_tc_plan_covers_each_voxel_once(shape):
    b, d, h, w = shape
    plan = conv3d_tc_plan(b, d, h, w, H100)
    assert plan.kd == 3 and plan.shape == shape
    _check_limits(plan)
    np.testing.assert_array_equal(_coverage(plan), 1)
    # what launch_tc<3> accepts: a 16 x 32 tile, a ring of 4 slabs of
    # 18 x 34 pixels, 54 KB of weights and 8 KB of staging
    assert (plan.th, plan.tw, plan.ring) == (16, 32, 4)
    assert plan.smem == 27 * 32 * 64 + 4 * 18 * 34 * 64 + 8 * 16 * 64
    tiles = -(-h // 16) * -(-w // 32)
    assert plan.grid == (tiles, -(-d // plan.steps), b)


def test_k3_plan_fills_the_card_at_batch_1():
    """At batch 1 the 90 x 160 plane holds 30 tiles: D is split so that the
    grid has more blocks than 30 and no more than one wave of 132 SMs."""
    plan = conv3d_tc_plan(1, 24, 90, 160, H100)
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert 30 < blocks <= 132
    assert plan.steps < 24


def test_k1_plan_fills_the_card_at_720p():
    """The 720 x 1280 launch fills the 2 x 132 block slots in one wave."""
    plan = conv3x3_tc_plan(1, 720, 1280, 1, H100)
    assert tc_blocks_per_sm(plan.smem, H100) == 2
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert 132 < blocks <= 264


@pytest.mark.parametrize("name,group", [
    ("void rsm::tc::conv_tc_kernel<1>(__nv_bfloat16 const*, ...)",
     "fused_conv3x3 32->32"),
    ("void rsm::tc::conv_tc_kernel<3>(__nv_bfloat16 const*, ...)",
     "fused_conv3d 32->32"),
    ("void rsm::tc::conv_tc_kernel<(int)3>(__nv_bfloat16 const*)",
     "fused_conv3d 32->32"),
    ("rsm::tc::conv_tc_kernel<(int)1>", "fused_conv3x3 32->32"),
    ("void rsm::conv_kernel<float, 32, 32, 1, 1, 3>(...)",
     "fused_conv3x3 32->32"),
    ("void rsm::conv_kernel<float, 32, 32, 1, 3, 3>(...)",
     "fused_conv3d 32->32"),
])
def test_frame_profile_groups_the_tensor_core_kernels(name, group):
    assert kernel_group(name) == group


def _bf16_operands(rng, x_shape, w_shape):
    """bf16-representable float32 arrays (the values the kernel would see)."""
    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    x = bf(rng.uniform(-1, 1, x_shape))
    w = bf(rng.uniform(-1, 1, w_shape) / np.sqrt(np.prod(w_shape[:-1])))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 32).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-0.3, 0.3, 32).astype(np.float32))
    return x, w, scale, bias


def _assert_within_bf16(got, want, what):
    """Within one bf16 ulp (up to 2^-7 relative): the two float32 sums may
    fall on either side of a bf16 rounding boundary."""
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("dilation,act,res", [(1, "relu", True),
                                              (8, 0.2, True),
                                              (4, "none", False)])
def test_bf16_conv3x3_on_cpu_runs_plain_and_matches_jax(rng, dilation, act,
                                                        res):
    import jax
    import jax.numpy as jnp

    x, w, scale, bias = _bf16_operands(rng, (2, 37, 53, 32), (3, 3, 32, 32))
    r = (torch.from_numpy(rng.uniform(-1, 1, (2, 37, 53, 32))
                          .astype(np.float32)).bfloat16() if res else None)
    got = fused_conv3x3(x, w, scale, bias, dilation=dilation, act=act,
                        residual=r)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, fused_conv3x3_plain(
        x, w, scale, bias, dilation=dilation, act=act, residual=r))
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x.float().numpy()), jnp.asarray(w.float().numpy()),
        (1, 1), [(dilation, dilation)] * 2, rhs_dilation=(dilation,) * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    y = y * scale.numpy() + bias.numpy()
    if act == "relu":
        y = jnp.maximum(y, 0.0)
    elif isinstance(act, float):
        y = jnp.maximum(y, 0.0) + act * jnp.minimum(y, 0.0)
    y = np.asarray(jnp.asarray(y).astype(jnp.bfloat16).astype(jnp.float32))
    if r is not None:
        y = y + r.float().numpy()
    _assert_within_bf16(got, y, f"d{dilation} {act} res={res}")


@pytest.mark.parametrize("relu", [True, False])
def test_bf16_conv3d_on_cpu_runs_plain_and_matches_jax(rng, relu):
    import jax
    import jax.numpy as jnp

    x, w, scale, bias = _bf16_operands(rng, (2, 5, 17, 33, 32),
                                       (3, 3, 3, 32, 32))
    got = fused_conv3d(x, w, scale, bias, relu=relu)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, fused_conv3d_plain(x, w, scale, bias,
                                                       relu=relu))
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x.float().numpy()), jnp.asarray(w.float().numpy()),
        (1, 1, 1), [(1, 1)] * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=jax.lax.Precision.HIGHEST)
    y = y * scale.numpy() + bias.numpy()
    if relu:
        y = jnp.maximum(y, 0.0)
    _assert_within_bf16(got, np.asarray(y), f"relu={relu}")


# the eval shapes, batch 1: validation at 320 x 448 (the held-out synthetic
# scenes) and at KITTI 2015's 375 x 1242 padded to 384 x 1280, each level of
# the frame (full to 1/8); the cost volume at 1/8 with D = 24
EVAL_HW = [(320, 448), (384, 1280)]
EVAL_LEVELS = [(1, h >> k, w >> k) for h, w in EVAL_HW for k in range(4)]
EVAL_K3 = [(1, 24, 40, 56), (1, 24, 48, 160)]


@pytest.mark.parametrize("pair", [(32, 32)] + sorted(TC_NARROW))
@pytest.mark.parametrize("shape", EVAL_LEVELS)
def test_k1_plans_cover_each_pixel_once_at_eval_shapes(shape, pair):
    n, h, w = shape
    for dilation in ((1, 2, 4, 8) if pair == (32, 32) else (1,)):
        plan = conv3x3_tc_plan(n, h, w, dilation, H100, *pair)
        assert plan.kd == 1 and plan.shape == (n, 1, h, w)
        _check_limits(plan)
        np.testing.assert_array_equal(_coverage(plan), 1)


@pytest.mark.parametrize("taps,cin", [(3, 32), (4, 32), (3, 3)])
@pytest.mark.parametrize("shape", [s for s in EVAL_LEVELS if s[1] >= 80])
def test_k2_plans_cover_each_output_once_at_eval_shapes(shape, taps, cin):
    """The stride-2 convs take the full, 1/2 and 1/4 levels: K2 3x3 (v1 /
    v2 encoders: the 3 -> 32 stem, then 32 -> 32) and K2-4x4 (v3 U-Net).
    ``conv_s2_tc_kernel`` maps block (x, y, z) to output columns
    32 x .. + 32, row tiles y x steps .. of 8 rows, batch z."""
    n, h, w = shape
    plan = conv_s2_tc_plan(n, h, w, taps, H100, cin)
    ho, wo = (h + 1) // 2, (w + 1) // 2
    assert plan.out_hw == (ho, wo)
    _check_limits(plan)
    hits = np.zeros((n, ho, wo), np.int32)
    gx, gy, gz = plan.grid
    for b in range(gz):
        for by in range(gy):
            for bx in range(gx):
                oy0 = by * plan.steps * plan.th
                hits[b, oy0:oy0 + plan.steps * plan.th,
                     bx * plan.tw:(bx + 1) * plan.tw] += 1
    np.testing.assert_array_equal(hits, 1)


@pytest.mark.parametrize("pair", [(32, 32), (32, 1), (1, 32)])
@pytest.mark.parametrize("shape", EVAL_K3)
def test_k3_plans_cover_each_voxel_once_at_eval_shapes(shape, pair):
    b, d, h, w = shape
    plan = conv3d_tc_plan(b, d, h, w, H100, *pair)
    assert plan.kd == 3 and plan.shape == shape
    _check_limits(plan)
    np.testing.assert_array_equal(_coverage(plan), 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tensor-core kernels run only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dilation", [1, 8])
def test_tc_kernels_on_cuda_match_plain(cuda_device, dilation):
    """The tensor-core kernels against their plain versions on ragged
    shapes, within chip_smoke.py's bf16 tolerance (atol 2e-2, rtol 1e-2)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=cuda_device) * 2 - 1

    scale, bias = rand(32) * 0.5 + 1.0, rand(32) * 0.3
    x, r = rand(3, 37, 53, 32).bfloat16(), rand(3, 37, 53, 32).bfloat16()
    w = (rand(3, 3, 32, 32) / 17).bfloat16()
    got = fused_conv3x3(x, w, scale, bias, dilation=dilation, residual=r)
    want = fused_conv3x3_plain(x.float(), w.float(), scale, bias,
                               dilation=dilation, residual=r.float())
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=1e-2)
    x3, w3 = rand(2, 5, 17, 33, 32).bfloat16(), (
        rand(3, 3, 3, 32, 32) / 29).bfloat16()
    torch.testing.assert_close(
        fused_conv3d(x3, w3, scale, bias).float(),
        fused_conv3d_plain(x3.float(), w3.float(), scale, bias),
        atol=2e-2, rtol=1e-2)


def _tc_compare():
    """``tools/tc_compare.py``, which times the kernels' cut variants and
    K3's wgmma form on the card (not a package: loaded from its path)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
        "tc_compare.py"
    spec = importlib.util.spec_from_file_location("tc_compare", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launch_tc_decl(text):
    i = text.index("cudaError_t launch_tc(")
    return " ".join(text[i:text.index(")", i)].split())


@pytest.mark.parametrize("macro", ["RSM_TC_CUT_A", "RSM_TC_CUT_MMA",
                                   "RSM_TC_CUT_STORE"])
def test_tc_compare_cut_macros_guard_the_kernel(macro):
    """Each macro a cut variant defines guards code of ``conv_tc.cuh``, and
    no build of the package defines it."""
    tool = _tc_compare()
    assert any(macro in (m or ()) for m in tool.VARIANTS.values())
    csrc = tool.ROOT / "realtime_stereo_matcher_tpu_torch" / "csrc"
    assert f"#ifndef {macro}\n" in (csrc / "conv_tc.cuh").read_text()
    for src in csrc.iterdir():
        assert f"#define {macro}" not in src.read_text()


@pytest.mark.parametrize("name", ["no MMA, no A fragments", "wgmma form"])
def test_tc_compare_makes_a_variant_copy(tmp_path, name):
    """A variant is a copy of the package whose ``conv_tc.cuh`` defines the
    cut macros ahead of the package's text, or is the wgmma form, which
    keeps the package's ``launch_tc`` interface."""
    tool = _tc_compare()
    root = tool.make_variant(name, tmp_path)
    header = (root / "realtime_stereo_matcher_tpu_torch" / "csrc" /
              "conv_tc.cuh").read_text()
    package = (tool.ROOT / "realtime_stereo_matcher_tpu_torch" / "csrc" /
               "conv_tc.cuh").read_text()
    if name == "wgmma form":
        assert "wgmma.mma_async" in header
        assert "wgmma" not in package
        assert _launch_tc_decl(header) == _launch_tc_decl(package)
    else:
        assert header == ("#define RSM_TC_CUT_MMA\n#define RSM_TC_CUT_A\n"
                          + package)
    assert not (root / "realtime_stereo_matcher_tpu_torch" / "_build").exists()
