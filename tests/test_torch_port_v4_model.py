"""The port's MobileStereoNetV4 against the JAX package, on the CPU.

* Weights drawn by the port's seeded init, BatchNorm running stats
  randomised, moved to JAX with ``import_torch_state_dict`` (the V4 Conv3d
  biases folded into the running means there): the plain port V4 in eval
  mode matches Flax ``MobileStereoNetV4.apply`` within 1e-3 px at
  1 x 64 x 96, float32;
* the batched interweave volume (``interweave_cost``) equals the
  reference's own per-shift loop -- interleave the left features with the
  right ones shifted, run the port's Conv3d stack and 1x1 reducer on that
  slice, write columns x >= s -- within 1e-5, with nonzero Conv3d biases, at
  every chunking of the shifts;
* train mode returns the 4 heads, eval mode the last, cropped back from
  the /16 padding; ``build_model`` builds V4 from every repo config that
  names it;
* a port state dict survives ``import_torch_state_dict`` and
  ``from_jax_variables`` exactly (with zero Conv3d biases, which the JAX
  package folds away), and JAX variables survive the other way exactly.

The JAX templates are traced with ``jax.eval_shape``: the importer reads
only their shapes, and an unjitted V4 init takes about a minute here.
"""

import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.models import build_model as jax_build_model
from realtime_stereo_matcher_tpu.models.torch_import import (
    import_torch_state_dict,
)
from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.models import MobileStereoNetV4, build_model
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.models.stereo_net_v4 import (
    interweave_cost,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
V4_TYPE = "MobileStereoNetV4"
V4 = {"type": V4_TYPE, "parameters": {"max_disp": 192}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the V4 and DispNetC files: under the suite's
    parallel workers, each spreading its convolutions over every core slows
    every worker to a crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def randomize_bn(model, seed):
    gen = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.running_mean.numel()
                m.running_mean.copy_(torch.from_numpy(
                    gen.normal(0, 0.3, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    gen.uniform(0.5, 1.5, n).astype(np.float32)))


def template(config):
    """The shapes of the Flax model's variables (``jax.eval_shape``)."""
    model = jax_build_model(config)
    img = jnp.zeros((1, 16, 16, 3), jnp.float32)
    return model, jax.eval_shape(
        lambda k: model.init(k, img, img, train=False), jax.random.PRNGKey(0))


def to_jax(port, config, shapes):
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    return import_torch_state_dict(config["type"], sd, shapes)


@pytest.fixture(scope="module")
def port_v4():
    """The port's seeded V4 with randomised BN running stats, its Flax model
    and the same weights as JAX variables."""
    model = build_model(V4, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    randomize_bn(model, 5)
    flax, shapes = template(V4)
    return model, flax, shapes, to_jax(model, V4, shapes)


def _images(rng, hw, batch=1):
    return tuple(rng.uniform(0, 255, (batch, *hw, 3)).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("hw", [(64, 96)])
def test_plain_v4_matches_flax(rng, port_v4, hw):
    model, flax, _, variables = port_v4
    left, right = _images(rng, hw)
    want = jax.jit(lambda v, a, b: flax.apply(v, a, b, train=False))(
        variables, left, right)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(left), torch.from_numpy(right))
    assert len(got) == len(want) == 1
    assert got[0].shape == want[0].shape == (1, *hw, 1)
    assert got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-3)
    assert float(got[0].max()) <= 0.0


def _reference_loop(model, feat_l, feat_r):
    """The reference's volume (mobile_stereo_net_v4.py:443-458): for each
    shift s, the interleaved (left[x >= s], right[x < w - s]) slice through
    the Conv3d stack and the 1x1 reducer, written at columns x >= s."""
    b, c, h, w = feat_l.shape
    vol = feat_l.new_zeros((b, model.volume_size, h, w))
    for s in range(min(model.volume_size, w)):
        pair = torch.stack([feat_l[..., s:], feat_r[..., :w - s]], dim=2)
        y = model.conv3d(pair.reshape(b, 1, 2 * c, h, w - s))
        vol[:, s, :, s:] = model.volume11(y[:, :, 0])[:, 0]
    return vol


@pytest.mark.parametrize("chunk", [48, 16, 5])
def test_interweave_cost_equals_the_reference_loop(chunk):
    model = build_model(V4, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    randomize_bn(model, 6)
    assert all(model.conv3d[i].bias.detach().abs().max() > 0
               for i in (0, 3, 6))
    gen = torch.Generator().manual_seed(2)
    feat_l, feat_r = (torch.randn(2, 32, 5, 52, generator=gen)
                      for _ in range(2))
    with torch.no_grad():
        want = _reference_loop(model, feat_l, feat_r)
        got = interweave_cost(model.conv3d, model.volume11, feat_l, feat_r,
                              48, chunk)
    assert got.shape == (2, 48, 5, 52)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # columns x < s are zero
    for s in range(48):
        assert not got[:, s, :, :s].any()


def test_train_mode_returns_the_four_heads(rng):
    """Train mode returns the 4 heads, eval mode the last, each cropped
    back from the model's /16 padding."""
    model = build_model(V4, device="cpu").train()
    left, right = _images(rng, (30, 45), batch=2)
    with torch.no_grad():
        heads = model(torch.from_numpy(left), torch.from_numpy(right))
        final = model.eval()(torch.from_numpy(left), torch.from_numpy(right))
    assert len(heads) == 4 and len(final) == 1
    assert all(h.shape == (2, 30, 45, 1) and h.dtype == torch.float32
               for h in heads + final)


@pytest.mark.parametrize("config", ["stereo_net_config_v4.json",
                                    "stereo_net_v4_synthetic_config.json"])
def test_build_model_from_the_repo_configs(config):
    cfg = load_config(ROOT / "configure" / config).model.as_dict()
    assert cfg["type"] == V4_TYPE
    model = build_model(cfg, device="cpu")
    assert type(model) is MobileStereoNetV4 and not model.training
    # the reference's parameters, and the three Conv3d biases the JAX
    # package folds into its running means
    assert sum(p.numel() for p in model.parameters()) == 2352642 + 64


def test_state_dict_round_trip(port_v4):
    model, _, shapes, _ = port_v4
    model = copy.deepcopy(model)
    with torch.no_grad():
        for i in (0, 3, 6):
            model.conv3d[i].bias.zero_()
    sd = model.state_dict()
    variables = to_jax(model, V4, shapes)
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert back[k].shape == v.shape and torch.equal(back[k], v), k
    # JAX -> port -> JAX
    again = import_torch_state_dict(
        V4_TYPE, {k: v.numpy() for k, v in back.items()}, shapes)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(variables)[0],
                            jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def test_conv3d_bias_folds_into_the_running_mean(port_v4):
    """A nonzero Conv3d bias is exact in eval mode both ways: the JAX
    importer folds it into the next running mean, the converter maps the
    folded mean back with a zero bias, and the eval forward agrees."""
    model, _, shapes, _ = port_v4
    model = copy.deepcopy(model)
    with torch.no_grad():
        for i in (0, 3, 6):
            model.conv3d[i].bias.uniform_(-0.5, 0.5)
    back = build_model(V4, device="cpu")
    back.load_state_dict(from_jax_variables(to_jax(model, V4, shapes)))
    assert all(not back.conv3d[i].bias.any() for i in (0, 3, 6))
    gen = torch.Generator().manual_seed(3)
    left, right = (torch.rand(1, 32, 48, 3, generator=gen) * 255
                   for _ in range(2))
    with torch.no_grad():
        want = model.eval()(left, right)[0]
        got = back.eval()(left, right)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
