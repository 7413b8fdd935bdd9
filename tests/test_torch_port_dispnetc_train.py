"""The port's MobileDispNetC training step and train-start init against the
JAX package, on the CPU.

Step: a DispNetC initialised by the JAX package's own train-start init
(``train/init.py``), BatchNorm running stats randomised, moved into the
port with ``from_jax_variables``; batch 2 at 128 x 192, float32;
SequenceLoss with the DispNetC configs' gamma 0.9.  Against Flax
``apply(..., train=True, mutable=["batch_stats"])`` and ``jax.grad``:

* the six heads within 1e-5 of each head's largest magnitude (they reach
  hundreds of px at the init), the loss within 1e-5 relative;
* every gradient within 1e-4 relative L2 (measured <= 5e-6), but for the
  biases of the convs that feed a train-mode BatchNorm (the residual
  blocks' convs and shortcuts): their gradient is zero, and both packages'
  come out as rounding, of norm < 1e-3 against O(10-100) elsewhere;
* every BatchNorm running-stat update within 1e-5, or 1e-6 relative (some
  running variances reach 10, where float32 holds 1e-6), the siamese conv1
  / conv2 updated twice (left, then right).

(At the port's own seeded init instead, one input of up2's leaky ReLU lies
5e-7 from 0; the JAX package's float32 puts it on the other side, in either
batch order, and moves up2's deconv gradients by 2.6e-3 relative L2 from the
port's float64 step, which the port's float32 step matches within 3.4e-6.)

Init: per tensor, the mean and standard deviation of the port's
``reference_initialize`` within sampling error of the JAX package's (for
V4 in tests/test_torch_port_v4_init.py): Conv2d kaiming-normal fan-out,
ConvTranspose2d kaiming-normal fan-in with torch's transposed fan-in,
every bias 0, BatchNorm ones / zeros.
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
from realtime_stereo_matcher_tpu_torch.train.init import reference_initialize
from realtime_stereo_matcher_tpu_torch.train.loss import sequence_loss
from test_torch_port_dispnetc_model import DNC
from test_torch_port_v4_model import (  # noqa: F401 (fixture)
    one_torch_thread,
    randomize_bn,
    template,
    to_jax,
)

GAMMA = 0.9
B, H, W = 2, 128, 192


def before_train_bn(model):
    """The biases of convs whose output goes straight into a train-mode
    BatchNorm: a zero gradient."""
    return {f"{r}.{c}.bias" for r in ("res4", "res5", "res6")
            for c in ("conv1", "conv2", "shortcut.0")}


def jax_initialized(config, seed=3):
    """The JAX package's ``reference_initialize`` of ``config``'s model, on
    the shapes of its variables (it draws every leaf), as the port's state
    dict."""
    flax = jax_build_model(config)
    img = jnp.zeros((1, 16, 16, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: flax.init(k, img, img, train=True),
                            jax.random.PRNGKey(0))
    return from_jax_variables(jax.jit(lambda k: jax_reference_initialize(
        shapes, k, model_type=config["type"]))(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def jax_init():
    return jax_initialized(DNC)


@pytest.fixture(scope="module")
def setup(jax_init):
    model = build_model(DNC, device="cpu")
    model.load_state_dict(jax_init)
    randomize_bn(model, 7)
    flax, shapes = template(DNC)
    variables = to_jax(model, DNC, shapes)
    gen = np.random.default_rng(7)
    left = gen.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    right = np.roll(left, -3, axis=2) + gen.normal(0, 4, left.shape)
    right = np.clip(right, 0, 255).astype(np.float32)
    flow = -gen.uniform(0, 40, (B, H, W, 1)).astype(np.float32)
    valid = (gen.uniform(size=(B, H, W)) > 0.2).astype(np.float32)

    @jax.jit
    def loss_and_grad(params, l, r, fl, vd):
        def loss_fn(p):
            preds, upd = flax.apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, l, r,
                train=True, mutable=["batch_stats"])
            return jax_sequence_loss(preds, fl, vd, loss_gamma=GAMMA), (
                preds, upd)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (loss, (preds, upd)), grads = loss_and_grad(variables["params"], left,
                                                right, flow, valid)
    return dict(
        model=model, batch=(left, right, flow, valid), loss=float(loss),
        preds=[np.asarray(p) for p in preds],
        stats=from_jax_variables({"params": variables["params"],
                                  "batch_stats": upd["batch_stats"]}),
        grads=from_jax_variables({"params": jax.tree_util.tree_map(
            np.asarray, grads)}))


def test_train_step_matches_flax(setup):
    model = setup["model"].train()
    left, right, flow, valid = (torch.from_numpy(a) for a in setup["batch"])
    preds = model(left, right)
    assert len(preds) == len(setup["preds"]) == 6
    for got, want in zip(preds, setup["preds"]):
        assert got.shape == want.shape == (B, H, W, 1)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * scale)
    loss = sequence_loss(preds, flow, valid, loss_gamma=GAMMA)
    np.testing.assert_allclose(float(loss.detach()), setup["loss"], rtol=1e-5)
    loss.backward()

    zero = before_train_bn(model)
    names = dict(model.named_parameters())
    assert set(names) == set(setup["grads"])
    for k, p in names.items():
        want = setup["grads"][k]
        if k in zero:
            assert float(p.grad.norm()) < 1e-3 and float(want.norm()) < 1e-3
            continue
        rel = float((p.grad - want).norm()) / float(want.norm())
        assert rel <= 1e-4, (k, rel)

    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert set(stats) == {k for k in setup["stats"]
                          if k.endswith(("running_mean", "running_var"))}
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), setup["stats"][k].numpy(),
                                   rtol=1e-6, atol=1e-5, err_msg=k)
    # the siamese convs saw two updates, the others one
    tracked = {k: int(v) for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked")}
    assert tracked["conv1.layer.1.num_batches_tracked"] == 2
    assert tracked["conv2.layer.1.num_batches_tracked"] == 2
    assert tracked["res4.bn1.num_batches_tracked"] == 1


def init_matches_jax(config, want):
    """The port's ``reference_initialize`` against the JAX package's
    (``want``, from :func:`jax_initialized`), in distribution, per tensor
    (shared with tests/test_torch_port_v4_init.py)."""
    port = build_model(config, device="cpu")
    with torch.no_grad():
        for m in port.modules():  # make the reset of BatchNorm visible
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.fill_(3.0)
                m.running_var.fill_(3.0)
    reference_initialize(port, torch.Generator().manual_seed(0))
    got = port.state_dict()
    bn = {f"{name}.{k}" for name, m in port.named_modules()
          if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
          for k in ("weight", "bias", "running_mean", "running_var")}
    checked = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k in bn or not w.any():  # BatchNorm; zero biases
            assert torch.equal(g, w), k
            continue
        if w.numel() < 256:  # a head's bias: too few values to compare
            continue
        ratio = float(g.std()) / float(w.std())
        assert abs(ratio - 1) < 0.15, (k, ratio)
        assert abs(float(g.mean())) < 0.2 * float(w.std()), k
        checked += 1
    assert checked >= 10
    return port


def test_reference_initialize_matches_jax_in_distribution(jax_init):
    port = init_matches_jax(DNC, jax_init)
    assert all(not m.bias.any() for m in port.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
               and m.bias is not None)
