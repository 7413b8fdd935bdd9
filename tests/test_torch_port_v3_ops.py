"""The port's v3 ops and its 4x4 stride-2 kernel against JAX, on the CPU.

* ``warp_by_flow_map`` (``F.grid_sample``) against the JAX package's
  gather warp within 2e-4 absolute on N(0, 1) images: grid_sample
  renormalizes the pixel position through [-1, 1] in float32, which moves it
  by ~1e-5 px at W = 300 (measured <= 1.3e-4 here);
* ``warp_by_flow_map_banded`` against ``warp_by_flow_map_matmul_banded``
  within 1e-6, flows beyond ``max_shift`` and below 0 and odd H and W
  included (the same two taps and float32 weights; measured <= 1.2e-7);
* ``fused_conv4x4_s2_plain`` against ``jax.lax.conv_general_dilated(...,
  "SAME")`` with the same epilogue, on even and odd sizes, within 1e-5 (one
  conv of <= 512 products, summed in another order), and against the JAX
  package's Pallas kernel in interpret mode (slow tier);
* the wrapper runs the plain version on CPU tensors and refuses other
  devices; ``frame_profile`` groups the 4x4 kernel under its own name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.ops.sampling import (
    warp_by_flow_map as jax_warp,
    warp_by_flow_map_matmul_banded as jax_warp_banded,
)
from realtime_stereo_matcher_tpu_torch.kernels import LAUNCHES
from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    fused_conv4x4_s2,
    fused_conv4x4_s2_plain,
)
from realtime_stereo_matcher_tpu_torch.models.layers import (
    SameConv2d,
    tf_same_pad_k4s2,
)
from realtime_stereo_matcher_tpu_torch.ops import (
    warp_by_flow_map,
    warp_by_flow_map_banded,
)

WARP_CASES = [
    # h, w, c, max_shift, flow range (beyond the band on both sides)
    (9, 33, 5, 8, (-3.0, 14.0)),
    (16, 300, 32, 20, (-2.0, 40.0)),
    (17, 129, 3, 64, (0.0, 100.0)),
]


def _warp_inputs(rng, h, w, c, lo, hi):
    img = rng.normal(size=(2, h, w, c)).astype(np.float32)
    flow = rng.uniform(lo, hi, (2, h, w, 1)).astype(np.float32)
    return img, flow


@pytest.mark.parametrize("h,w,c,max_shift,flow_range", WARP_CASES)
def test_warp_by_flow_map_matches_jax(rng, h, w, c, max_shift, flow_range):
    img, flow = _warp_inputs(rng, h, w, c, *flow_range)
    want = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(flow)))
    got = warp_by_flow_map(torch.from_numpy(img), torch.from_numpy(flow))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("h,w,c,max_shift,flow_range", WARP_CASES)
def test_warp_banded_matches_jax(rng, h, w, c, max_shift, flow_range):
    img, flow = _warp_inputs(rng, h, w, c, *flow_range)
    want = np.asarray(jax_warp_banded(jnp.asarray(img), jnp.asarray(flow),
                                      max_shift))
    got = warp_by_flow_map_banded(torch.from_numpy(img),
                                  torch.from_numpy(flow), max_shift)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the band is live: some pixels are zeroed by it, others are not
    off_band = np.abs(want).max(-1) == 0
    assert 0 < off_band.mean() < 1


def test_warp_banded_is_the_full_warp_in_band(rng):
    img, flow = _warp_inputs(rng, 12, 40, 4, 0.0, 10.0)
    full = warp_by_flow_map(torch.from_numpy(img), torch.from_numpy(flow))
    banded = warp_by_flow_map_banded(torch.from_numpy(img),
                                     torch.from_numpy(flow), 10)
    np.testing.assert_allclose(banded.numpy(), full.numpy(), rtol=0,
                               atol=1e-4)


def _jax_conv4x4(x, w, scale, bias, act):
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    y = y * scale + bias
    if act == "relu":
        y = jnp.maximum(y, 0.0)
    elif isinstance(act, float):
        y = jnp.maximum(y, 0.0) + act * jnp.minimum(y, 0.0)
    return np.asarray(y)


def _conv4x4_operands(rng, shape):
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    w = rng.uniform(-1, 1, (4, 4, 32, 32)).astype(np.float32) / np.sqrt(512)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    bias = rng.normal(0, 0.3, 32).astype(np.float32)
    return x, w, scale, bias


@pytest.mark.parametrize("act", [0.2, "relu", "none"])
@pytest.mark.parametrize("hw", [(16, 40), (15, 33), (9, 8), (1, 5)])
def test_fused_conv4x4_s2_plain_matches_jax(rng, hw, act):
    x, w, scale, bias = _conv4x4_operands(rng, (2, *hw, 32))
    want = _jax_conv4x4(x, w, scale, bias, act)
    t = [torch.from_numpy(a) for a in (x, w, scale, bias)]
    got = fused_conv4x4_s2_plain(*t, act=act)
    assert got.shape == want.shape == (2, (hw[0] + 1) // 2,
                                       (hw[1] + 1) // 2, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    before = sum(LAUNCHES.values())
    assert torch.equal(fused_conv4x4_s2(*t, act=act), got)
    assert sum(LAUNCHES.values()) == before


@pytest.mark.parametrize("n", [8, 9, 1])
def test_same_conv2d_is_tf_same(rng, n):
    lo, hi = tf_same_pad_k4s2(n)
    assert lo == 1 and lo + hi == max((-(-n // 2) - 1) * 2 + 4 - n, 0)
    conv = SameConv2d(32, 32)
    x, _, _, _ = _conv4x4_operands(rng, (1, n, n + 3, 32))
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
        w = conv.weight.permute(2, 3, 1, 0).numpy()
        want = _jax_conv4x4(x, w, np.ones(32, np.float32),
                            conv.bias.numpy(), "none")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


def test_fused_conv4x4_s2_refuses_other_devices():
    x = torch.empty(1, 8, 8, 32, device="meta")
    w = torch.empty(4, 4, 32, 32, device="meta")
    s = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_conv4x4_s2(x, w, s, s)


@pytest.mark.slow
def test_fused_conv4x4_s2_plain_matches_pallas_kernel(rng):
    """Against the JAX package's Pallas kernel ``fused_conv4x4_s2_flat`` in
    interpret mode at 16 x 64, as tests/test_kernel_conv3x3.py runs it, at
    its tolerance."""
    from realtime_stereo_matcher_tpu.kernels.conv3x3 import (
        fold_conv4x4_s2_weights,
        from_flat,
        fused_conv4x4_s2_flat,
        plain_scale_bias,
        to_flat,
    )

    h, w, c = 16, 64, 32
    x = rng.standard_normal((1, h, w, c), dtype=np.float32)
    wts = rng.standard_normal((4, 4, c, c), dtype=np.float32) * 0.1
    bias = rng.standard_normal((c,), dtype=np.float32)
    scale128, b128 = plain_scale_bias(jnp.asarray(bias), c, 32)
    yf = fused_conv4x4_s2_flat(to_flat(jnp.asarray(x), 32, phase=2),
                               fold_conv4x4_s2_weights(jnp.asarray(wts), 32,
                                                       32),
                               scale128, b128, relu=0.2)
    want = np.asarray(from_flat(yf, h // 2, w // 2, c, 32, phase=0))
    got = fused_conv4x4_s2_plain(torch.from_numpy(x), torch.from_numpy(wts),
                                 torch.ones(c), torch.from_numpy(bias),
                                 act=0.2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name,group", [
    ("void rsm::conv_kernel<__nv_bfloat16, 32, 32, 2, 1, 4>(...)",
     "fused_conv4x4_s2 32->32"),
    ("void rsm::conv_kernel<__nv_bfloat16, 3, 32, 1, 1, 3>(...)",
     "fused_conv3x3 3->32"),
    ("void rsm::conv_kernel<float, 32, 32, 2, 1, 3>(...)",
     "fused_conv3x3_s2 32->32"),
    ("void rsm::conv_kernel<float, 32, 1, 1, 3, 3>(...)", "fused_conv3d 32->1"),
])
def test_frame_profile_names_each_conv_kernel(name, group):
    """The profiler's kernel groups tell the 4x4 conv from the 3x3 ones by
    the shared kernel's tap-count template argument."""
    from realtime_stereo_matcher_tpu_torch.frame_profile import kernel_group

    assert kernel_group(name) == group
