"""The port's tensor ops against their JAX counterparts, on the CPU.

Inputs are made with numpy and fed to both frameworks.  Tolerance: 1e-5
absolute; the ops are the same float32 arithmetic, summed or interpolated in
another order (torch's bilinear weights w0*v0 + w1*v1 against JAX's
v0 + t*(v1 - v0)), on values of order 1 (disparities of order 10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.models import layers as jlayers
from realtime_stereo_matcher_tpu.models import stereo_net as jnet
from realtime_stereo_matcher_tpu.ops import cost_volume as jcv
from realtime_stereo_matcher_tpu.ops import padding as jpad
from realtime_stereo_matcher_tpu.ops import sampling as jsamp
from realtime_stereo_matcher_tpu_torch.models import layers as tlayers
from realtime_stereo_matcher_tpu_torch.models import stereo_net as tnet
from realtime_stereo_matcher_tpu_torch.ops import cost_volume as tcv
from realtime_stereo_matcher_tpu_torch.ops import padding as tpad
from realtime_stereo_matcher_tpu_torch.ops import sampling as tsamp

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("hw", [(64, 128), (61, 127), (5, 3)])
@pytest.mark.parametrize("mode", ["constant", "edge"])
def test_pad_to_multiple(rng, hw, mode):
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    got, got_hw = tpad.pad_to_multiple(torch.from_numpy(x), 8, mode=mode)
    want, want_hw = jpad.pad_to_multiple(jnp.asarray(x), 8, mode=mode)
    assert got_hw == want_hw
    _close(got, want, atol=0)


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
def test_input_padder(rng, mode):
    x = rng.normal(size=(1, 37, 53, 3)).astype(np.float32)
    tp = tpad.InputPadder(x.shape, mode=mode)
    jp = jpad.InputPadder(x.shape, mode=mode)
    assert tp.padded_shape == jp.padded_shape
    (got,) = tp.pad(torch.from_numpy(x))
    (want,) = jp.pad(jnp.asarray(x))
    _close(got, want, atol=0)
    _close(tp.unpad(got), jp.unpad(want), atol=0)
    _close(tp.unpad(got), x, atol=0)


@pytest.mark.parametrize("src,dst", [((8, 16), (16, 32)), ((64, 128), (16, 32)),
                                     ((12, 20), (24, 40)), ((9, 7), (20, 11))])
def test_resize_bilinear(rng, src, dst):
    x = rng.uniform(-1, 1, size=(1, *src, 3)).astype(np.float32)
    _close(tsamp.resize_bilinear(torch.from_numpy(x), dst),
           jsamp.resize_bilinear(jnp.asarray(x), dst))


@pytest.mark.parametrize("src,dst", [((8, 16), (64, 128)), ((9, 7), (20, 11))])
def test_resize_nearest(rng, src, dst):
    x = rng.uniform(-1, 1, size=(2, *src, 1)).astype(np.float32)
    _close(tsamp.resize_nearest(torch.from_numpy(x), dst),
           jsamp.resize_nearest(jnp.asarray(x), dst), atol=0)


def test_shift_stack(rng):
    f = rng.normal(size=(2, 5, 16, 4)).astype(np.float32)
    got, got_valid = tcv.shift_stack(torch.from_numpy(f), 7)
    want, want_valid = jcv.shift_stack(jnp.asarray(f), 7)
    _close(got, want, atol=0)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))


@pytest.mark.parametrize("max_disp", [8, 24])
def test_difference_cost_volume(rng, max_disp):
    left = rng.normal(size=(1, 8, 16, 32)).astype(np.float32)
    right = rng.normal(size=(1, 8, 16, 32)).astype(np.float32)
    got = tcv.difference_cost_volume(torch.from_numpy(left),
                                     torch.from_numpy(right), max_disp)
    want = jcv.difference_cost_volume(jnp.asarray(left), jnp.asarray(right),
                                      max_disp)
    _close(got, want, atol=0)
    # the invalid region (x < d) holds the reference fill value 1.0
    assert float(got[0, 3, 0, 0, 0]) == 1.0


@pytest.mark.parametrize("axis", [1, 3])
def test_soft_argmin(rng, axis):
    cost = rng.normal(size=(2, 24, 8, 16)).astype(np.float32) * 3
    _close(tcv.soft_argmin(torch.from_numpy(cost), axis=axis),
           jcv.soft_argmin(jnp.asarray(cost), axis=axis))


def test_normalize_images(rng):
    img = rng.uniform(0, 255, size=(1, 8, 16, 3)).astype(np.float32)
    _close(tlayers.normalize_images(torch.from_numpy(img)),
           jlayers.normalize_images(jnp.asarray(img)))


@pytest.mark.parametrize("orig_hw", [(64, 128), (60, 125)])
def test_full_res_nearest(rng, orig_hw):
    disp = rng.uniform(0, 20, size=(1, 8, 16, 1)).astype(np.float32)
    _close(tnet._full_res_nearest(torch.from_numpy(disp), (64, 128), orig_hw),
           jnet._full_res_nearest(jnp.asarray(disp), (64, 128), orig_hw))
