"""The port's v1 training forward and gradients against Flax, on the CPU.

Weights: a Flax v1 initialised by the JAX package's own train-start init
(``train/init.py``), BatchNorm running stats randomised, moved into the port
with ``from_jax_variables``.  Batch 2 at 32 x 64, float32.  The oracle is
``MobileStereoNet.apply(..., train=True, mutable=["batch_stats"])``; the
port's kernel path (``fast_train_forward``, whose kernels run their plain
versions on CPU tensors) and its plain model in ``train()`` mode are each
held to it, at the tolerances of the JAX package's tests/test_fast_train.py:

* predictions within rtol 1e-3, atol 2e-3;
* BatchNorm running stats within 1e-4;
* SequenceLoss gradients per parameter within a relative L2 of max(6 x the
  Flax path's own noise floor, 1e-2), the floor measured by re-running Flax
  on the batch in reverse order (mathematically the same gradient, summed in
  another order); leaves whose gradient is ~0 by symmetry (norm < 1e-3, e.g.
  the encoder head bias, which cancels in the difference volume) are
  skipped, as there.  Flax gradients reach the port's names through
  ``from_jax_variables({"params": grads})``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.models import build_model as jax_build_model
from realtime_stereo_matcher_tpu.train.init import (
    reference_initialize as jax_reference_initialize,
)
from realtime_stereo_matcher_tpu.train.loss import (
    sequence_loss as jax_sequence_loss,
)
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.models.fast_train import (
    fast_train_forward,
    running_stats,
)
from realtime_stereo_matcher_tpu_torch.models.stereo_net import RefineNet
from realtime_stereo_matcher_tpu_torch.train.loss import sequence_loss

V1 = {"type": "MobileStereoNet", "parameters": {}}
B, H, W = 2, 32, 64


@pytest.fixture(scope="module")
def setup():
    """Flax variables, the batch, and the Flax loss / grads / BN updates on
    the batch and on the batch reversed."""
    model = jax_build_model(V1)
    gen = np.random.default_rng(7)
    left = gen.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    right = np.roll(left, -3, axis=2) + gen.normal(0, 4, left.shape)
    right = np.clip(right, 0, 255).astype(np.float32)
    flow = -gen.uniform(0, 40, (B, H, W, 1)).astype(np.float32)
    valid = (gen.uniform(size=(B, H, W)) > 0.2).astype(np.float32)

    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, dummy, dummy, train=True))(
        jax.random.PRNGKey(0))
    variables = jax_reference_initialize(dict(variables),
                                         jax.random.PRNGKey(1),
                                         model_type="MobileStereoNet")

    def randomize(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name == "mean":
            return gen.normal(0, 0.3, shape).astype(np.float32)
        if name == "var":
            return gen.uniform(0.5, 1.5, shape).astype(np.float32)
        return np.asarray(leaf)

    variables = jax.tree_util.tree_map_with_path(randomize, variables)

    @jax.jit
    def loss_and_grad(params, l, r, fl, vd):
        def loss_fn(p):
            preds, upd = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, l, r,
                train=True, mutable=["batch_stats"])
            return jax_sequence_loss(preds, fl, vd), (preds, upd)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (loss, (preds, upd)), grads = loss_and_grad(
        variables["params"], left, right, flow, valid)
    _, grads_rev = loss_and_grad(variables["params"], left[::-1],
                                 right[::-1], flow[::-1], valid[::-1])
    return dict(
        variables=variables, batch=(left, right, flow, valid),
        loss=float(loss), preds=[np.asarray(p) for p in preds],
        stats=from_jax_variables({"params": variables["params"],
                                  "batch_stats": upd["batch_stats"]}),
        grads=from_jax_variables({"params": grads}),
        grads_rev=from_jax_variables({"params": grads_rev}))


def _port(setup):
    model = build_model(V1, device="cpu")
    model.load_state_dict(from_jax_variables(setup["variables"]))
    return model.train()


def _batch(setup):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in setup["batch"]]


def _check_preds_and_stats(setup, preds, stats):
    assert len(preds) == 3
    for got, want in zip(preds, setup["preds"]):
        assert got.shape == want.shape == (B, H, W, 1)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-3,
                                   atol=2e-3)
    keys = [k for k in setup["stats"] if k.endswith(("_mean", "_var"))]
    assert sorted(keys) == sorted(stats)
    for k in keys:
        np.testing.assert_allclose(stats[k].numpy(), setup["stats"][k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def _check_grads(setup, model, slack=6.0, rel=1e-2):
    names = dict(model.named_parameters())
    assert set(names) == set(setup["grads"])
    checked = 0
    for k, p in names.items():
        want, rev = setup["grads"][k], setup["grads_rev"][k]
        norm = float(want.norm()) + 1e-20
        if norm < 1e-3:
            continue
        diff = float((p.grad - want).norm()) / norm
        floor = float((want - rev).norm()) / norm
        assert diff <= max(slack * floor, rel), (k, diff, floor, norm)
        checked += 1
    assert checked > 0.9 * len(names)


def test_fast_train_forward_matches_flax(setup):
    model = _port(setup)
    left, right, flow, valid = _batch(setup)
    before = {k: v.clone() for k, v in running_stats(model).items()}
    preds, stats = fast_train_forward(model, left, right, train=True)
    _check_preds_and_stats(setup, preds, stats)
    loss = sequence_loss(preds, flow, valid)
    np.testing.assert_allclose(float(loss.detach()), setup["loss"], rtol=1e-4)
    loss.backward()
    _check_grads(setup, model)
    # the model's own running stats are untouched: the new ones come back
    for k, v in running_stats(model).items():
        assert torch.equal(v, before[k]), k


def test_plain_model_in_train_mode_matches_flax(setup):
    model = _port(setup)
    left, right, flow, valid = _batch(setup)
    preds = model(left, right)
    _check_preds_and_stats(setup, preds, running_stats(model))
    loss = sequence_loss(preds, flow, valid)
    np.testing.assert_allclose(float(loss.detach()), setup["loss"], rtol=1e-4)
    loss.backward()
    _check_grads(setup, model)


def test_fast_train_forward_eval_mode_is_the_plain_eval_model(setup):
    """train=False normalises with the running stats and returns them
    unchanged."""
    model = _port(setup).eval()
    left, right, _, _ = _batch(setup)
    with torch.no_grad():
        want = model(left, right)
        got, stats = fast_train_forward(model, left, right, train=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-4)
    for k, v in running_stats(model).items():
        assert torch.equal(stats[k], v), k


def test_fast_train_forward_bf16_tracks_f32(setup):
    model = _port(setup)
    left, right, _, _ = _batch(setup)
    with torch.no_grad():
        want = fast_train_forward(model, left, right)[0][-1]
        got = fast_train_forward(model, left, right, dtype=torch.bfloat16)[0][-1]
    assert got.dtype == torch.float32
    assert float((got - want).abs().median()) < 1.0


def test_fast_train_forward_is_v1_only():
    """The kernel train path took v1 only until v2 and v3 were ported; it
    raises naming ROADMAP.md on anything else."""
    with pytest.raises(NotImplementedError,
                       match="v1, v2 and v3.*ROADMAP.md"):
        fast_train_forward(RefineNet(), None, None)
