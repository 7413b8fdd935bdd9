"""The layers and ops of the V4 and DispNetC slice against the JAX package, on
the CPU.

Inputs are made with numpy and fed to both frameworks, float32, at small
shapes; values are of order 1 (disparities of order 10):

* ``GroupedBatchNorm2d`` against the JAX ``GroupedBatchNorm``: train mode
  (each view normalized by its own statistics, the running stats updated
  in the closed form) and eval mode, within 1e-5; one grouped pass equals
  two sequential passes of one port ``BatchNorm2d``; ``frozen_bn`` pins it;
* ``MobileV2Residual``, ``ConvBNDws``, ``MobileV1Residual`` (stride 1 and
  2, dilated, with and without the downsample) and ``ConvTransposeBN`` in
  eval and train mode against their Flax modules, the weights moved with the
  JAX package's own importer helpers, within 1e-5;
* ``resize_trilinear``, ``interweave_volume`` and ``correlation_cost_volume``
  (against both JAX implementations, the matmul and the elementwise one)
  within 1e-5, and ``soft_argmin_trilinear`` forward within 1e-5 or 1e-6
  relative (its expectations reach ~100 px) and its gradient within 1e-6
  of its largest magnitude of ``jax.grad`` through the JAX custom VJP;
* ``leaky_relu_01`` and ``relu6``, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.models import layers as jlayers
from realtime_stereo_matcher_tpu.models.torch_import import _Importer
from realtime_stereo_matcher_tpu.ops import cost_volume as jcv
from realtime_stereo_matcher_tpu.ops import sampling as jsamp
from realtime_stereo_matcher_tpu_torch.models import layers as tlayers
from realtime_stereo_matcher_tpu_torch.ops import cost_volume as tcv
from realtime_stereo_matcher_tpu_torch.ops import sampling as tsamp
from realtime_stereo_matcher_tpu_torch.train.freeze import frozen_bn
from test_torch_port_v4_model import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _randomize(module, gen):
    """Random affine and running stats on every BatchNorm of ``module``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                for t, (lo, hi) in ((m.weight, (0.5, 1.5)),
                                    (m.bias, (-0.3, 0.3)),
                                    (m.running_mean, (-0.3, 0.3)),
                                    (m.running_var, (0.5, 1.5))):
                    t.copy_(torch.from_numpy(
                        gen.uniform(lo, hi, n).astype(np.float32)))


# ---------------------------------------------------------------------------
# GroupedBatchNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_grouped_batch_norm_matches_jax(rng, groups):
    b, h, w, c = 2 * groups, 5, 7, 6
    x = (rng.normal(size=(b, h, w, c)) * rng.uniform(0.5, 3, c)
         + rng.normal(size=c)).astype(np.float32)
    port = tlayers.GroupedBatchNorm2d(c, groups)
    _randomize(port, rng)
    params = {"scale": port.weight.detach().numpy(),
              "bias": port.bias.detach().numpy()}
    stats = {"mean": port.running_mean.numpy().copy(),
             "var": port.running_var.numpy().copy()}
    jbn = jlayers.GroupedBatchNorm(groups=groups)

    want, upd = jbn.apply({"params": params, "batch_stats": stats}, x,
                          use_running_average=False, mutable=["batch_stats"])
    got = port.train()(_nchw(x))
    _close(_nhwc(got), want)
    _close(port.running_mean, upd["batch_stats"]["mean"])
    _close(port.running_var, upd["batch_stats"]["var"])
    assert int(port.num_batches_tracked) == groups

    want = jbn.apply({"params": params, "batch_stats": upd["batch_stats"]},
                     x[:1], use_running_average=True)
    with torch.no_grad():
        got = port.eval()(_nchw(x[:1]))  # eval takes any batch
    _close(_nhwc(got), want)


def test_grouped_batch_norm_is_two_sequential_passes(rng):
    """[left; right] through one grouped pass = one BatchNorm on left, then
    on right (the reference's two extractor calls)."""
    x = rng.normal(1.0, 2.0, size=(4, 3, 5, 6)).astype(np.float32)
    grouped = tlayers.GroupedBatchNorm2d(3, 2)
    _randomize(grouped, rng)
    plain = tlayers.batch_norm2d(3)
    plain.load_state_dict(grouped.state_dict())
    got = grouped.train()(torch.from_numpy(x))
    plain.train()
    want = torch.cat([plain(torch.from_numpy(x[:2])),
                      plain(torch.from_numpy(x[2:]))])
    _close(got, want.detach().numpy())
    _close(grouped.running_mean, plain.running_mean.numpy())
    _close(grouped.running_var, plain.running_var.numpy())
    assert isinstance(plain, tlayers.BatchNorm2d)


def test_frozen_bn_pins_grouped_batch_norm(rng):
    model = torch.nn.Sequential(tlayers.GroupedBatchNorm2d(3, 2))
    _randomize(model, rng)
    x = torch.from_numpy(rng.normal(size=(4, 3, 5, 6)).astype(np.float32))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.eval()
    with torch.no_grad():
        want = model(x)
    model.train()
    with frozen_bn(model), torch.no_grad():
        got = model(x)
    assert model.training and model[0].training
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# MobileNet blocks and the transposed conv, through the JAX importer
# ---------------------------------------------------------------------------


def _flax_vars(port, mapper, bn_groups):
    """``port``'s weights as the Flax variables of the same block, mapped
    by the JAX package's importer helper ``mapper(importer, "m", "f")``."""
    sd = {f"m.{k}": v.numpy() for k, v in port.state_dict().items()}
    imp = _Importer(sd)
    mapper(imp, "m", "f")
    assert imp.used == {k for k in imp.sd}  # every weight consumed
    return {"params": imp.params["f"], "batch_stats": imp.stats["f"]}


BLOCKS = {
    "v2 s1 res": (lambda bg: tlayers.MobileV2Residual(8, 8, 1, 3,
                                                      bn_groups=bg),
                  lambda bg: jlayers.MobileV2Residual(8, 8, 1, 3,
                                                      bn_groups=bg),
                  _Importer.mobilev2_, 8),
    "v2 s2": (lambda bg: tlayers.MobileV2Residual(3, 8, 2, 3, bn_groups=bg),
              lambda bg: jlayers.MobileV2Residual(3, 8, 2, 3, bn_groups=bg),
              _Importer.mobilev2_, 3),
    "v1 s2 down": (lambda bg: tlayers.MobileV1Residual(
                       8, 16, 2, True, 1, 1, bn_groups=bg),
                   lambda bg: jlayers.MobileV1Residual(
                       8, 16, 2, True, 1, 1, bn_groups=bg),
                   _Importer.mobilev1_, 8),
    "v1 dilated": (lambda bg: tlayers.MobileV1Residual(
                       8, 8, 1, False, 1, 2, bn_groups=bg),
                   lambda bg: jlayers.MobileV1Residual(
                       8, 8, 1, False, 1, 2, bn_groups=bg),
                   _Importer.mobilev1_, 8),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
@pytest.mark.parametrize("bn_groups", [1, 2])
@pytest.mark.parametrize("train", [False, True])
def test_mobilenet_blocks_match_flax(rng, name, bn_groups, train):
    make_port, make_flax, mapper, cin = BLOCKS[name]
    port = make_port(bn_groups)
    tlayers.init_parameters(port, torch.Generator().manual_seed(0))
    _randomize(port, rng)
    variables = _flax_vars(port, mapper, bn_groups)
    x = rng.normal(size=(2 * bn_groups, 9, 11, cin)).astype(np.float32)
    if train:
        want, upd = make_flax(bn_groups).apply(
            variables, x, True, mutable=["batch_stats"])
        got = port.train()(_nchw(x))
        new = {f"m.{k}": v.numpy() for k, v in port.state_dict().items()}
        imp = _Importer(new)
        mapper(imp, "m", "f")
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                upd["batch_stats"])[0]:
            node = imp.stats["f"]
            for p in path:
                node = node[p.key]
            _close(node, leaf)
    else:
        want = make_flax(bn_groups).apply(variables, x, False)
        with torch.no_grad():
            got = port.eval()(_nchw(x))
    _close(_nhwc(got), want)


def test_conv_bn_dws_matches_flax(rng):
    port = tlayers.ConvBNDws(6, 10, 2, 1, 1, second_relu=False)
    tlayers.init_parameters(port, torch.Generator().manual_seed(1))
    _randomize(port, rng)

    def mapper(imp, tp, fp):
        for q, ti in enumerate((0, 3)):
            imp.conv(f"{tp}.{ti}", f"{fp}/ConvBN_{q}/Conv_0")
            imp.bn(f"{tp}.{ti + 1}", f"{fp}/ConvBN_{q}/BatchNorm_0")

    variables = _flax_vars(port, mapper, 1)
    x = rng.normal(size=(2, 9, 11, 6)).astype(np.float32)
    want = jlayers.ConvBNDws(6, 10, 2, 1, 1, second_relu=False).apply(
        variables, x, False)
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    _close(_nhwc(got), want)


@pytest.mark.parametrize("hw", [(4, 6), (5, 7)])
def test_conv_transpose_bn_matches_flax(rng, hw):
    """k 3, stride 2, padding 1, output_padding 1 (V4's hourglass) against
    Flax ``ConvTranspose`` with explicit ((1, 2), (1, 2)) padding."""
    port = tlayers.ConvTransposeBN(8, 4)
    tlayers.init_parameters(port, torch.Generator().manual_seed(2))
    _randomize(port, rng)

    def mapper(imp, tp, fp):
        imp.convt(f"{tp}.0", f"{fp}/ConvTranspose_0")
        imp.bn(f"{tp}.1", f"{fp}/BatchNorm_0")

    variables = _flax_vars(port, mapper, 1)
    x = rng.normal(size=(2, *hw, 8)).astype(np.float32)
    flax = jlayers.ConvTransposeBN(4, kernel_size=(3, 3),
                                   padding=((1, 2), (1, 2)))
    want = flax.apply(variables, x, False)
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    assert got.shape[2:] == (2 * hw[0], 2 * hw[1])
    _close(_nhwc(got), want)


def test_activations_match_jax(rng):
    x = rng.normal(0, 5, size=(3, 17)).astype(np.float32)
    np.testing.assert_array_equal(
        tlayers.leaky_relu_01(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.leaky_relu_01(x)))
    np.testing.assert_array_equal(tlayers.relu6(torch.from_numpy(x)).numpy(),
                                  np.asarray(jlayers.relu6(x)))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((12, 4, 6), (48, 16, 24)),
                                     ((48, 5, 7), (192, 20, 28)),
                                     ((6, 8, 8), (4, 5, 11))])
def test_resize_trilinear(rng, src, dst):
    x = rng.normal(size=(2, *src, 3)).astype(np.float32)
    _close(tsamp.resize_trilinear(torch.from_numpy(x), dst),
           jsamp.resize_trilinear(jnp.asarray(x), dst))
    # NCDHW axes as V4's volume lays them out
    xc = np.ascontiguousarray(np.moveaxis(x, -1, 1))
    _close(tsamp.resize_trilinear(torch.from_numpy(xc), dst, d_axis=2,
                                  h_axis=3, w_axis=4),
           jsamp.resize_trilinear(jnp.asarray(xc), dst, d_axis=2, h_axis=3,
                                  w_axis=4))


def test_interweave_volume(rng):
    left = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    right = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    got = tcv.interweave_volume(torch.from_numpy(left), torch.from_numpy(right))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcv.interweave_volume(left, right)))
    np.testing.assert_array_equal(got.numpy()[..., 0::2], left)
    np.testing.assert_array_equal(got.numpy()[..., 1::2], right)


@pytest.mark.parametrize("use_matmul", [True, False])
@pytest.mark.parametrize("shape,max_disp", [((2, 6, 20, 16), 12),
                                            ((1, 3, 9, 5), 12)])
def test_correlation_cost_volume(rng, use_matmul, shape, max_disp):
    left = rng.normal(size=shape).astype(np.float32)
    right = rng.normal(size=shape).astype(np.float32)
    got = tcv.correlation_cost_volume(torch.from_numpy(left),
                                      torch.from_numpy(right), max_disp)
    want = jcv.correlation_cost_volume(jnp.asarray(left), jnp.asarray(right),
                                       max_disp, use_matmul=use_matmul)
    _close(got, want)
    assert got.dtype == torch.float32
    out = got.numpy()
    for d in range(max_disp):  # zero where x < d
        assert not out[:, d, :, :d].any()


@pytest.mark.parametrize("shape,out_d,out_hw", [((2, 48, 4, 6), 192, (16, 24)),
                                                ((1, 12, 5, 7), 40, (20, 28)),
                                                ((1, 48, 3, 3), 192, (3, 3))])
def test_soft_argmin_trilinear_and_its_gradient(rng, shape, out_d, out_hw):
    vol = rng.normal(0, 2, size=shape).astype(np.float32)
    g = rng.normal(size=(shape[0], *out_hw)).astype(np.float32)
    t = torch.from_numpy(vol).requires_grad_(True)
    got = tcv.soft_argmin_trilinear(t, out_d, out_hw)
    want = jcv.soft_argmin_trilinear(jnp.asarray(vol), out_d, out_hw)
    assert got.dtype == torch.float32
    # expectations over near-flat softmaxes reach ~100 px, where float32
    # holds ~1e-5 px: the bound is 1e-5 px or 1e-6 relative
    _close(got, want, rtol=1e-6)
    (got * torch.from_numpy(g)).sum().backward()
    want_g = jax.grad(lambda v: jnp.sum(
        jcv.soft_argmin_trilinear(v, out_d, out_hw) * g))(jnp.asarray(vol))
    _close(t.grad, want_g, atol=1e-6 * float(np.abs(want_g).max()))
    # the plain definition: soft-argmin of the trilinear upsample
    dense = tcv.soft_argmin(tsamp.resize_trilinear(
        torch.from_numpy(vol), (out_d, *out_hw)), axis=1)
    _close(got, dense.numpy(), rtol=1e-6)
