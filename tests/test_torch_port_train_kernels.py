"""The port's training kernels against JAX, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version, so these tests
hold the plain versions (what the CUDA kernels are checked against on the
card) and the autograd wiring around them to JAX's own oracles:

* ``dw_reduce_plain`` / ``dw_reduce3d_plain`` (K4) against ``jax.vjp`` of
  ``lax.conv_general_dilated`` with respect to the weights -- the oracle of
  the JAX package's tests/test_train_conv.py -- for every dilation and
  channel pair of the training path, within 1e-4 (float32 sums of <= 800
  products of order-1 values, taken in another order);
* ``flat_conv3x3`` (K5) and ``flat_conv3d`` (K6): forward, dx and dW against
  ``jax.vjp`` of the lax conv, within 1e-4, and ``torch.autograd.gradcheck``
  in float64;
* the train-mode BatchNorm against flax ``nn.BatchNorm``: running stats
  within 1e-6 relative at 64 pixels per channel, where torch's unbiased
  variance (a factor 64/63 on the update) would be off by 1.6%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from realtime_stereo_matcher_tpu_torch.kernels import LAUNCHES
from realtime_stereo_matcher_tpu_torch.kernels.train_conv import (
    dw_reduce,
    dw_reduce3d,
    dw_reduce3d_plain,
    dw_reduce_plain,
    flat_conv3x3,
)
from realtime_stereo_matcher_tpu_torch.kernels.train_conv3d import flat_conv3d
from realtime_stereo_matcher_tpu_torch.models.layers import (
    BatchNorm2d,
    BatchNorm3d,
)

TOL = dict(rtol=1e-4, atol=1e-4)
PAIRS_2D = [(32, 32, d) for d in (1, 2, 4, 8)] + [(4, 32, 1), (32, 1, 1)]
PAIRS_3D = [(32, 32), (32, 1)]


def _lax_conv(x, w, dilation=1):
    nd = x.ndim - 2
    dims = ("NHWC", "HWIO", "NHWC") if nd == 2 else ("NDHWC", "DHWIO", "NDHWC")
    return jax.lax.conv_general_dilated(
        x, w, (1,) * nd, [(dilation, dilation)] * nd,
        rhs_dilation=(dilation,) * nd, dimension_numbers=dims,
        precision=jax.lax.Precision.HIGHEST)


def _jax_vjp(x, w, cot, dilation=1):
    """(y, dx, dw) of the lax conv at x, w with cotangent ``cot``."""
    y, vjp = jax.vjp(lambda a, b: _lax_conv(a, b, dilation), jnp.asarray(x),
                     jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(cot))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _uniform(rng, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("cin,cout,dilation", PAIRS_2D)
def test_dw_reduce_plain_matches_jax_grad(rng, cin, cout, dilation):
    x, g = _uniform(rng, 2, 11, 19, cin), _uniform(rng, 2, 11, 19, cout)
    w = _uniform(rng, 3, 3, cin, cout)
    _, _, want = _jax_vjp(x, w, g, dilation)
    got = dw_reduce_plain(torch.from_numpy(x), torch.from_numpy(g), dilation)
    assert got.dtype == torch.float32 and got.shape == (3, 3, cin, cout)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("cin,cout", PAIRS_3D)
def test_dw_reduce3d_plain_matches_jax_grad(rng, cin, cout):
    x, g = _uniform(rng, 2, 5, 6, 9, cin), _uniform(rng, 2, 5, 6, 9, cout)
    w = _uniform(rng, 3, 3, 3, cin, cout)
    _, _, want = _jax_vjp(x, w, g)
    got = dw_reduce3d_plain(torch.from_numpy(x), torch.from_numpy(g))
    assert got.shape == (3, 3, 3, cin, cout)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dw_wrappers_run_the_plain_version_on_cpu(rng):
    x, g = _uniform(rng, 1, 6, 7, 32), _uniform(rng, 1, 6, 7, 1)
    LAUNCHES.clear()
    got = dw_reduce(torch.from_numpy(x), torch.from_numpy(g), 2)
    want = dw_reduce_plain(torch.from_numpy(x), torch.from_numpy(g), 2)
    assert torch.equal(got, want)
    x3, g3 = _uniform(rng, 1, 3, 4, 5, 32), _uniform(rng, 1, 3, 4, 5, 32)
    assert torch.equal(dw_reduce3d(torch.from_numpy(x3), torch.from_numpy(g3)),
                       dw_reduce3d_plain(torch.from_numpy(x3),
                                         torch.from_numpy(g3)))
    assert not LAUNCHES  # no kernel was counted


def _check_autograd(rng, fn, x_shape, w_shape, cot_shape, dilation=1):
    x, w = _uniform(rng, *x_shape), _uniform(rng, *w_shape) * 0.3
    cot = _uniform(rng, *cot_shape)
    want_y, want_dx, want_dw = _jax_vjp(x, w, cot, dilation)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = fn(xt, wt)
    y.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), want_dw, **TOL)


@pytest.mark.parametrize("cin,cout,dilation", PAIRS_2D)
def test_flat_conv3x3_matches_jax_vjp(rng, cin, cout, dilation):
    _check_autograd(rng, lambda x, w: flat_conv3x3(x, w, dilation),
                    (2, 12, 18, cin), (3, 3, cin, cout), (2, 12, 18, cout),
                    dilation)


@pytest.mark.parametrize("cin,cout", PAIRS_3D)
def test_flat_conv3d_matches_jax_vjp(rng, cin, cout):
    _check_autograd(rng, flat_conv3d, (2, 4, 5, 7, cin),
                    (3, 3, 3, cin, cout), (2, 4, 5, 7, cout))


def test_flat_convs_pass_gradcheck():
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=torch.float64) - 0.5

    x, w = rand(1, 5, 6, 3).requires_grad_(), rand(3, 3, 3, 2).requires_grad_()
    for d in (1, 2):
        assert torch.autograd.gradcheck(lambda a, b: flat_conv3x3(a, b, d),
                                        (x, w))
    x3 = rand(1, 3, 4, 4, 2).requires_grad_()
    w3 = rand(3, 3, 3, 2, 2).requires_grad_()
    assert torch.autograd.gradcheck(flat_conv3d, (x3, w3))


def test_flat_conv_weight_grad_keeps_the_weight_dtype(rng):
    """A bf16 activation with float32 weights (the bf16 training path):
    the output is bf16, the weight gradient float32."""
    x = torch.from_numpy(_uniform(rng, 1, 6, 8, 4)).bfloat16()
    w = torch.from_numpy(_uniform(rng, 3, 3, 4, 32)).requires_grad_()
    y = flat_conv3x3(x.requires_grad_(), w)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32 and x.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("ndim", [2, 3])
def test_train_batchnorm_matches_flax(rng, ndim):
    """64 pixels per channel: 2 x 4 x 8 (2D) and 2 x 2 x 4 x 4 (3D)."""
    c = 6
    spatial = (4, 8) if ndim == 2 else (2, 4, 4)
    x = (rng.standard_normal((2, *spatial, c)) * 2.0 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.3, c).astype(np.float32)
    mean0 = rng.normal(0, 0.3, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    port = (BatchNorm2d if ndim == 2 else BatchNorm3d)(c)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    port.train()
    xt = torch.from_numpy(x).movedim(-1, 1)
    got = port(xt).movedim(1, -1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(port, name).numpy(), np.asarray(upd["batch_stats"][key]),
            rtol=1e-6, atol=0, err_msg=name)
    # the same call with torch's own BatchNorm misses by the factor n/(n-1)
    torch_bn = (torch.nn.BatchNorm2d if ndim == 2 else torch.nn.BatchNorm3d)(c)
    with torch.no_grad():
        torch_bn.running_var.copy_(torch.from_numpy(var0))
    torch_bn.train()(xt)
    assert not np.allclose(torch_bn.running_var.numpy(),
                           np.asarray(upd["batch_stats"]["var"]), rtol=1e-3)
