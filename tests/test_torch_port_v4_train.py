"""The port's MobileStereoNetV4 training step against the JAX package, on
the CPU.

Weights: the trained V4 (``weights/synth_stereo_net_v4-20001.pt``), moved to
JAX with ``import_torch_state_dict``.  The oracle is Flax
``apply(..., train=True, mutable=["batch_stats"])`` and ``jax.grad``,
float32.

The volume and the hourglass, in train mode on their own (random features,
batch 2), the port in float64 against the JAX package in float32: output
within 5e-5, every BatchNorm running-stat update within 1e-5, every
gradient, the inputs' included, within 1e-4 relative L2.  (In float32 a
single ReLU whose input lies within 1e-6 of 0 may switch sides, which moves
the volume's input gradients by 2e-3 relative L2 near that pixel, on either
side: the port's float32 pass does so on these features, the JAX package's
does not.)

The whole step (two synthetic scenes at 48 x 64, batch 2, SequenceLoss with
the V4 configs' gamma 0.7) amplifies float32 rounding far past those bounds,
mostly in the extractor (25 MobileNet blocks with grouped BatchNorms): the
port's own float32 gradients differ from its float64 ones by up to 3e-2
relative L2 (up to 0.7 at the train-start init), and the JAX package's
gradients on the batch in reverse order (the same sums in another order)
from its own by 0.5 at the init; the JAX package's float32 on the CPU strays
further from the exact result than the port's (its extractor's gradients up
to 40 x).  The step is therefore held to the port's float64 step, the port's
math without rounding, against a float32 floor: the largest error from the
float64 result of the port in float32, of the port on the batch reversed and
of the JAX package on the batch reversed.  Per tensor, a gradient's relative
L2 within max(1e-4, 16 x its floor) and the median over tensors of error /
floor at most 1.5 (a difference of the math would move them all, not the
tail; measured: median 1.07, worst 9.9); a running stat within max(1e-5, 6 x
its floor) (measured <= 3.3 x); each head within max(2e-3 px, 4 x its
floor); the loss within 1e-4 relative.  DispNetC's step holds 1e-4 / 1e-5
outright (tests/test_torch_port_dispnetc_train.py).

The three Conv3d biases, which the JAX package folds away, get a gradient
that is zero in float64 (they sit before train-mode BatchNorms); under
``frozen_bn`` the step leaves every running stat, the grouped ones too, as
it was and still returns 4 heads.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.models import stereo_net_v4 as jv4
from realtime_stereo_matcher_tpu.train.loss import (
    sequence_loss as jax_sequence_loss,
)
from realtime_stereo_matcher_tpu_torch.data.synthetic import make_scene
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.checkpoint import load_weights
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.models.stereo_net_v4 import (
    interweave_cost,
)
from realtime_stereo_matcher_tpu_torch.train.freeze import frozen_bn
from realtime_stereo_matcher_tpu_torch.train.loss import sequence_loss
from test_torch_port_eval import ROOT, TRAINED
from test_torch_port_v4_model import (  # noqa: F401 (fixture)
    V4,
    one_torch_thread,
    template,
    to_jax,
)

GAMMA = 0.7
B, H, W = 2, 48, 64
# the Conv3d biases: no JAX counterpart (folded into the running means)
FOLDED = ("conv3d.0.bias", "conv3d.3.bias", "conv3d.6.bias")


def _batch():
    scenes = [make_scene(seed, H, W, max_disp=16.0) for seed in (11, 12)]
    left, right, disp, valid = (np.stack([s[i] for s in scenes])
                                for i in range(4))
    return (left.astype(np.float32), right.astype(np.float32),
            -disp[..., None].astype(np.float32), valid.astype(np.float32))


def _port_step(model, batch, dtype):
    """(heads, loss, gradients, new running stats) of the plain train-mode
    step on a copy of ``model`` in ``dtype``."""
    model = copy.deepcopy(model).to(dtype).train()
    left, right, flow, valid = (torch.from_numpy(a) for a in batch)
    preds = model(left.to(dtype), right.to(dtype))
    loss = sequence_loss(preds, flow, valid, loss_gamma=GAMMA)
    loss.backward()
    grads = {k: p.grad.double() for k, p in model.named_parameters()}
    return ([p.detach().double() for p in preds], float(loss.detach()),
            grads, _stats(model))


def _stats(model):
    return {k: v.double() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _reversed(batch):
    return tuple(np.ascontiguousarray(a[::-1]) for a in batch)


def _flip(step):
    """A step on the reversed batch with its heads in the batch's order."""
    preds, loss, grads, stats = step
    return [p.flip(0) for p in preds], loss, grads, stats


def _jax_steps(flax, variables, batches):
    """The JAX package's (heads, loss, gradients, stats) on each batch, in
    the port's names."""

    @jax.jit
    def loss_and_grad(params, left, right, flow, valid):
        def loss_fn(p):
            preds, upd = flax.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                left, right, train=True, mutable=["batch_stats"])
            return (jax_sequence_loss(preds, flow, valid, loss_gamma=GAMMA),
                    (preds, upd))

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    steps = []
    for batch in batches:
        (loss, (preds, upd)), grads = loss_and_grad(variables["params"],
                                                    *batch)
        stats = from_jax_variables({"params": variables["params"],
                                    "batch_stats": upd["batch_stats"]})
        grads = from_jax_variables({"params": jax.tree_util.tree_map(
            np.asarray, grads)})
        steps.append(([torch.from_numpy(np.asarray(p)).double()
                       for p in preds], float(loss),
                      {k: v.double() for k, v in grads.items()
                       if k not in FOLDED},
                      {k: v.double() for k, v in stats.items()
                       if k.endswith(("running_mean", "running_var"))}))
    return steps


@pytest.fixture(scope="module")
def trained():
    port = build_model(V4, device="cpu")
    load_weights(ROOT / TRAINED["v4"]["weights"], port)
    flax, shapes = template(V4)
    return port, flax, to_jax(port, V4, shapes)


@pytest.fixture(scope="module")
def setup(trained):
    port, flax, variables = trained
    batch = _batch()
    jax_step, jax_rev = _jax_steps(flax, variables, [batch, _reversed(batch)])
    return dict(
        port=port, batch=batch, jax=jax_step,
        f64=_port_step(port, batch, torch.float64),
        floors=[_port_step(port, batch, torch.float32),
                _flip(_port_step(port, _reversed(batch), torch.float32)),
                _flip(jax_rev)])


def test_train_heads_and_loss_match_flax(setup):
    preds, loss, _, _ = setup["jax"]
    exact, exact_loss, _, _ = setup["f64"]
    assert len(preds) == len(exact) == 4
    for i, (got, want) in enumerate(zip(preds, exact)):
        assert got.shape == want.shape == (B, H, W, 1)
        err = float((got - want).abs().max())
        floor = max(float((f[0][i] - want).abs().max())
                    for f in setup["floors"])
        assert err <= max(2e-3, 4 * floor), (i, err, floor)
    np.testing.assert_allclose(loss, exact_loss, rtol=1e-4)
    np.testing.assert_allclose(setup["floors"][0][1], exact_loss, rtol=1e-4)


def test_train_gradients_match_jax_grad(setup):
    _, _, want, _ = setup["jax"]
    _, _, exact, _ = setup["f64"]
    assert set(want) == set(exact) - set(FOLDED)
    ratios = []
    for k, w in want.items():
        norm = float(exact[k].norm())
        assert norm > 0, k
        err = float((w - exact[k]).norm()) / norm
        floor = max(float((f[2][k] - exact[k]).norm())
                    for f in setup["floors"]) / norm
        assert err <= max(1e-4, 16 * floor), (k, err, floor)
        ratios.append(err / max(floor, 1e-4))
    assert float(np.median(ratios)) <= 1.5, np.median(ratios)
    for k in FOLDED:  # before train-mode BatchNorms: zero in float64
        scale = float(exact[f"conv3d.{int(k.split('.')[1]) + 1}.weight"].norm())
        assert float(exact[k].norm()) < 1e-9 * scale, k


def test_train_running_stats_match_flax(setup):
    _, _, _, want = setup["jax"]
    _, _, _, exact = setup["f64"]
    assert set(want) == set(exact)
    for k, w in want.items():
        err = float((w - exact[k]).abs().max())
        floor = max(float((f[3][k] - exact[k]).abs().max())
                    for f in setup["floors"])
        assert err <= max(1e-5, 6 * floor), (k, err, floor)


def test_frozen_bn_step_keeps_every_running_stat(setup):
    model = copy.deepcopy(setup["port"]).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    left, right = (torch.from_numpy(a) for a in setup["batch"][:2])
    with frozen_bn(model):
        preds = model(left, right)
    assert len(preds) == 4
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# the parts in train mode on their own
# ---------------------------------------------------------------------------


def _part_step(trained, key, flax_part, port_part, inputs, prefix, seed):
    """One train-mode pass of a part of V4 on both sides: the JAX part
    ``flax_part`` with the variables under ``key``, the port's
    ``port_part(model, *inputs)`` on a float64 copy of the model, each with
    the cotangent of a seeded random output.  Returns {"jax" or
    torch.float64: (output, input gradients, parameter gradients under
    ``prefix``, running stats under ``prefix``)}."""
    port, _, variables = trained
    params = variables["params"][key]
    stats = variables["batch_stats"][key]

    def apply(p, *xs):
        return flax_part.apply({"params": p, "batch_stats": stats}, *xs,
                               train=True, mutable=["batch_stats"])

    shape = jax.eval_shape(apply, params, *inputs)[0].shape
    g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)

    def loss(p, *xs):
        out, upd = apply(p, *xs)
        return jnp.sum(out * g), (out, upd)

    grads, (out, upd) = jax.jit(jax.grad(
        loss, argnums=tuple(range(1 + len(inputs))), has_aux=True))(
        params, *inputs)
    tree = jax.tree_util.tree_map(np.zeros_like, variables["params"])
    tree[key] = jax.tree_util.tree_map(np.asarray, grads[0])
    want_g = from_jax_variables({"params": tree})
    want_s = from_jax_variables({
        "params": variables["params"],
        "batch_stats": dict(variables["batch_stats"], **{key: upd[
            "batch_stats"]})})
    want = (torch.from_numpy(np.array(out)).double(),
            [torch.from_numpy(np.array(x)).double() for x in grads[1:]],
            {k: v.double() for k, v in want_g.items()
             if k.startswith(prefix) and k not in FOLDED},
            {k: v.double() for k, v in want_s.items()
             if k.startswith(prefix) and "running" in k})
    model = copy.deepcopy(port).double().train()
    xs = [torch.from_numpy(x).double().requires_grad_(True) for x in inputs]
    got = port_part(model, *xs)
    (got * torch.from_numpy(g).double()).sum().backward()
    return (got.detach(), [x.grad for x in xs],
            {k: p.grad for k, p in model.named_parameters()
             if k.startswith(prefix) and k not in FOLDED},
            {k: v for k, v in _stats(model).items() if k.startswith(prefix)}
            ), want


def _nchw(model_fn):
    """A port part on NCHW made to take and give NHWC, as the Flax part."""
    return lambda m, *xs: model_fn(
        m, *(x.permute(0, 3, 1, 2) for x in xs)).permute(0, 2, 3, 1)


def _rel(a, b):
    return float((a - b).norm()) / float(b.norm())


PARTS = {
    "volume": ("InterweaveVolume_0", lambda: jv4.InterweaveVolume(
        n_shifts=48, chunk=48),
        lambda m, a, b: interweave_cost(m.conv3d, m.volume11,
                                        a.permute(0, 3, 1, 2),
                                        b.permute(0, 3, 1, 2), 48),
        [(2, 6, 40, 32), (2, 6, 40, 32)], ("conv3d", "volume11")),
    "hourglass": ("Hourglass2D_0", lambda: jv4.Hourglass2D(48),
                  _nchw(lambda m, x: m.encoder_decoder1(x)),
                  [(2, 8, 12, 48)], "encoder_decoder1"),
}


@pytest.mark.parametrize("name", sorted(PARTS))
def test_part_in_train_mode_matches_flax(trained, name):
    key, flax_part, port_part, shapes, prefix = PARTS[name]
    gen = np.random.default_rng(3)
    inputs = [gen.normal(size=s).astype(np.float32) for s in shapes]
    (out, dx, grads, stats), (want, want_dx, want_g, want_s) = _part_step(
        trained, key, flax_part(), port_part, inputs, prefix, seed=4)
    assert out.shape == want.shape
    assert float((out - want).abs().max()) <= 5e-5
    for a, b in zip(dx, want_dx):
        assert _rel(a, b) <= 1e-4
    assert set(grads) == set(want_g) and grads
    for k, w in want_g.items():
        assert _rel(grads[k], w) <= 1e-4, (k, _rel(grads[k], w))
    assert set(stats) == set(want_s) and stats
    for k, w in want_s.items():
        assert float((stats[k] - w).abs().max()) <= 1e-5, k
