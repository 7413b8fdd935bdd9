"""The port's v2 and v3 training (kernel path) against Flax, on the CPU.

Weights: a Flax v2 or v3 initialised by the JAX package's own train-start
init (``train/init.py``), BatchNorm running stats randomised, moved into the
port with ``from_jax_variables``.  Batch 2 at 32 x 64, float32.  The oracle
is ``model.apply(..., train=True, mutable=["batch_stats"])``; the port's
kernel path (``fast_train_forward``, whose kernels run their plain versions
on CPU tensors) is held to it at the tolerances of the JAX package's
tests/test_fast_train.py:

* predictions within rtol 1e-3, atol 2e-3;
* BatchNorm running stats within 1e-4;
* SequenceLoss gradients per parameter within a relative L2 of max(6 x a
  noise floor, 1e-2) of Flax's gradient (the rule of
  tests/test_fast_train.py); leaves with a gradient norm < 1e-3 are
  skipped, as there.  Here the oracle is Flax's gradient in float64
  (``jax.enable_x64``) and the floor is Flax's own float32 gradient's
  distance from it.  The floor of tests/test_fast_train.py, Flax re-run on
  the batch in reverse order, measures only the order of the sums: at this
  train-start init, batch 2 and 32 x 64, float32 rounding moves some refine
  and U-Net leaves by ~1e-2 (Flax's float32 gradient sits 1.1e-2 from its
  float64 one on a v2 refine leaf where the reversed batch moves it 1e-3;
  the port's plain float32 v3 step sits 1.1e-2 from it on a U-Net leaf).

The kernel-path gradients are also held to the port's plain step (the
model's own forward in train mode) by the same rule, the floor the plain
step's own distance from Flax's float64 gradient.  The flow's
gradient through the warp is held to Flax's at one RefineNet, and shown to
matter.  The wrappers are counted per step against the launch counts that
``chip_smoke.py`` asserts.  The slow tier holds the port's step to the JAX
kernel train path (Pallas in interpret mode) on the same weights.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.models import build_model as jax_build_model
from realtime_stereo_matcher_tpu.models.stereo_net import (
    RefineNet as JaxRefineNet,
)
from realtime_stereo_matcher_tpu.train.init import (
    reference_initialize as jax_reference_initialize,
)
from realtime_stereo_matcher_tpu.train.loss import (
    sequence_loss as jax_sequence_loss,
)
from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.data.synthetic import SyntheticBatches
from realtime_stereo_matcher_tpu_torch.kernels import (
    train_conv,
    train_conv3d,
)
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models import fast_train
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.parallel import halo
from realtime_stereo_matcher_tpu_torch.models.fast_train import (
    fast_step_supported,
    fast_train_forward,
    refine_net_train,
    running_stats,
)
from realtime_stereo_matcher_tpu_torch.train.init import reference_initialize
from realtime_stereo_matcher_tpu_torch.train.loss import sequence_loss
from realtime_stereo_matcher_tpu_torch.train.trainer import train

ROOT = pathlib.Path(__file__).resolve().parent.parent
VARIANTS = {"v2": "MobileStereoNetV2", "v3": "MobileStereoNetV3"}
B, H, W = 2, 32, 64
# wrapper calls of one training step (forward and backward): K1 forward
# and dx, K3 forward and dx, K4 in 2D and 3D
CALLS_PER_STEP = {
    "v2": {"fused_conv3x3": 108, "fused_conv3d": 10, "dw_reduce": 54,
           "dw_reduce3d": 5},
    "v3": {"fused_conv3x3": 78, "fused_conv3d": 10, "dw_reduce": 39,
           "dw_reduce3d": 5},
}


def _spec(variant):
    return {"type": VARIANTS[variant], "parameters": {}}


def _batch_np(seed=7):
    gen = np.random.default_rng(seed)
    left = gen.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    right = np.roll(left, -3, axis=2) + gen.normal(0, 4, left.shape)
    right = np.clip(right, 0, 255).astype(np.float32)
    flow = -gen.uniform(0, 40, (B, H, W, 1)).astype(np.float32)
    valid = (gen.uniform(size=(B, H, W)) > 0.2).astype(np.float32)
    return left, right, flow, valid


def _flax_setup(variant):
    """Flax variables (train-start init, BN stats randomised), the batch,
    the Flax float32 loss, predictions, BN updates and gradients, and the
    Flax float64 gradients."""
    model = jax_build_model(_spec(variant))
    left, right, flow, valid = _batch_np()
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, dummy, dummy, train=True))(
        jax.random.PRNGKey(0))
    variables = jax_reference_initialize(dict(variables),
                                         jax.random.PRNGKey(1),
                                         model_type=VARIANTS[variant])
    gen = np.random.default_rng(3)

    def randomize(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name == "mean":
            return gen.normal(0, 0.3, shape).astype(np.float32)
        if name == "var":
            return gen.uniform(0.5, 1.5, shape).astype(np.float32)
        return np.asarray(leaf)

    variables = jax.tree_util.tree_map_with_path(randomize, variables)

    @jax.jit
    def loss_and_grad(variables, l, r, fl, vd):
        def loss_fn(p):
            preds, upd = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, l, r,
                train=True, mutable=["batch_stats"])
            return jax_sequence_loss(preds, fl, vd), (preds, upd)

        return jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])

    (loss, (preds, upd)), grads32 = loss_and_grad(variables, left, right,
                                                  flow, valid)
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), tree)

        grads = f64(loss_and_grad(f64(variables),
                                  *f64((left, right, flow, valid)))[1])
    return dict(
        variant=variant, model=model, variables=variables,
        batch=(left, right, flow, valid), loss=float(loss),
        preds=[np.asarray(p) for p in preds],
        stats=from_jax_variables({"params": variables["params"],
                                  "batch_stats": upd["batch_stats"]}),
        # the float64 gradients, stored as float32 (6e-8 relative)
        grads=from_jax_variables({"params": grads}),
        grads32=from_jax_variables({"params": grads32}))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def setup(request):
    return _flax_setup(request.param)


def _port(setup):
    model = build_model(_spec(setup["variant"]), device="cpu")
    model.load_state_dict(from_jax_variables(setup["variables"]))
    return model.train()


def _batch(setup, reverse=False):
    return [torch.from_numpy(np.ascontiguousarray(a[::-1] if reverse else a))
            for a in setup["batch"]]


def _grads(model, preds, flow, valid):
    model.zero_grad(set_to_none=True)
    loss = sequence_loss(preds, flow, valid)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _check_grads(grads, want, other, slack=6.0, rel=1e-2):
    """Per-parameter relative L2 from ``want`` within max(slack x floor,
    rel); the floor is ``other``'s relative L2 from ``want``."""
    assert set(grads) == set(want)
    checked = 0
    for k, g in grads.items():
        norm = float(want[k].norm()) + 1e-20
        if norm < 1e-3:
            continue
        diff = float((g - want[k]).norm()) / norm
        floor = float((other[k] - want[k]).norm()) / norm
        assert diff <= max(slack * floor, rel), (k, diff, floor, norm)
        checked += 1
    assert checked > 0.9 * len(grads)


def test_fast_train_forward_matches_flax(setup):
    model = _port(setup)
    left, right, flow, valid = _batch(setup)
    before = {k: v.clone() for k, v in running_stats(model).items()}
    preds, stats = fast_train_forward(model, left, right, train=True)
    assert len(preds) == 3
    for got, want in zip(preds, setup["preds"]):
        assert got.shape == want.shape == (B, H, W, 1)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-3,
                                   atol=2e-3)
    keys = [k for k in setup["stats"] if k.endswith(("_mean", "_var"))]
    assert sorted(keys) == sorted(stats)
    if setup["variant"] == "v3":  # the U-Net has no BatchNorm
        assert not any(k.startswith("feature_extractor") for k in keys)
    for k in keys:
        np.testing.assert_allclose(stats[k].numpy(), setup["stats"][k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    loss, grads = _grads(model, preds, flow, valid)
    np.testing.assert_allclose(loss, setup["loss"], rtol=1e-4)
    _check_grads(grads, setup["grads"], setup["grads32"])
    for k, v in running_stats(model).items():  # new stats come back
        assert torch.equal(v, before[k]), k


def test_kernel_step_gradients_match_the_plain_step(setup):
    """The kernel path's gradients against the port's plain step (the
    model's own forward in train mode, with the kernel path's banded warp),
    within max(6 x the plain step's own distance from Flax's float64
    gradient, 1e-2)."""
    model = _port(setup)
    left, right, flow, valid = _batch(setup)
    stats0 = {k: v.clone() for k, v in running_stats(model).items()}
    _, plain = _grads(model, model(left, right, banded_warp=True), flow,
                      valid)
    fast_train.load_running_stats(model, stats0)
    preds, _ = fast_train_forward(model, left, right)
    _, fast = _grads(model, preds, flow, valid)
    _check_grads(fast, plain, setup["grads"])


def test_train_step_calls_each_kernel_as_counted(setup, monkeypatch):
    """K1 108 / 78, K3 10 and K4 59 / 44 wrapper calls per v2 / v3 step
    (forward and backward); v2's entries add three 7 -> 32 K1 calls, three
    32 -> 7 (their dx) and three 7 -> 32 K4 calls."""
    calls = {}

    def counting(module, name):
        fn = getattr(module, name)

        def wrapper(x, w_or_g, *args, **kwargs):
            key = (name, x.shape[-1], w_or_g.shape[-1])
            calls[key] = calls.get(key, 0) + 1
            return fn(x, w_or_g, *args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    counting(train_conv, "fused_conv3x3")
    counting(train_conv, "dw_reduce")
    counting(train_conv3d, "fused_conv3d")
    counting(train_conv3d, "dw_reduce3d")
    model = _port(setup)
    left, right, flow, valid = _batch(setup)
    preds, _ = fast_train_forward(model, left, right, dtype=torch.bfloat16)
    sequence_loss(preds, flow, valid).backward()
    totals = {}
    for (name, _, _), n in calls.items():
        totals[name] = totals.get(name, 0) + n
    assert totals == CALLS_PER_STEP[setup["variant"]]
    if setup["variant"] == "v2":
        assert calls[("fused_conv3x3", 7, 32)] == 3
        assert calls[("fused_conv3x3", 32, 7)] == 3
        assert calls[("dw_reduce", 7, 32)] == 3


def test_warp_passes_the_flow_gradient(setup, monkeypatch):
    """The disparity reaches the output through the concat and through the
    warp's tap weights: the gradient with respect to the disparity input of
    one RefineNet (level 1, eval-mode BatchNorm) matches Flax's within
    1e-4 relative L2, and a warp whose flow is detached misses it by far
    more."""
    variant, variables = setup["variant"], setup["variables"]
    model = _port(setup)
    gen = np.random.default_rng(5)
    h, w = 8, 16
    disp = gen.uniform(0, 40, (B, h, w, 1)).astype(np.float32)
    c = 3 if variant == "v2" else 32
    gh, gw = (8 * h, 8 * w) if variant == "v2" else (2 * h, 2 * w)
    l_g = gen.uniform(-1, 1, (B, gh, gw, c)).astype(np.float32)
    r_g = gen.uniform(-1, 1, (B, gh, gw, c)).astype(np.float32)
    cot = gen.normal(size=(B, 2 * h, 2 * w, 1)).astype(np.float32)
    name = "RefineNet_1"
    flax_rn = JaxRefineNet(32, (1, 2, 4, 8, 1, 1), warp_guidance=True)
    rn_vars = {"params": variables["params"][name],
               "batch_stats": variables["batch_stats"][name]}
    want = np.asarray(jax.grad(lambda d: jnp.sum(flax_rn.apply(
        rn_vars, d, jnp.asarray(l_g), jnp.asarray(r_g)) * cot))(
            jnp.asarray(disp)))
    refines, prefix = ((model.refine_layer, "refine_layer") if variant == "v2"
                       else (model.refine_layers, "refine_layers"))

    def port_grad():
        d = torch.from_numpy(disp).requires_grad_()
        out = refine_net_train(refines[1], d, torch.from_numpy(l_g),
                               running_stats(model), f"{prefix}.1",
                               torch.from_numpy(r_g), 112, train=False)
        (out * torch.from_numpy(cot)).sum().backward()
        return d.grad.numpy()

    def rel(g):
        return float(np.linalg.norm(g - want) / np.linalg.norm(want))

    assert rel(port_grad()) < 1e-4
    warp = halo.warp_by_flow_map_banded
    monkeypatch.setattr(halo, "warp_by_flow_map_banded",
                        lambda img, flow, ms: warp(img, flow.detach(), ms))
    assert rel(port_grad()) > 1e-2


@pytest.mark.slow
def test_kernel_step_matches_jax_kernel_path(setup):
    """The port's kernel train forward against the JAX package's kernel
    train forward (its Pallas kernels in interpret mode) on the same
    weights: predictions and BatchNorm updates at the rules above; the
    gradients of both against Flax's float64 gradient, by the rule above."""
    from realtime_stereo_matcher_tpu.models.fast_train import (
        fast_train_forward as jax_fast_train_forward,
    )

    variables = setup["variables"]
    left, right, flow, valid = setup["batch"]

    def loss_fn(p):
        preds, upd = jax_fast_train_forward(
            setup["model"], p, variables["batch_stats"], jnp.asarray(left),
            jnp.asarray(right), train=True)
        return jax_sequence_loss(preds, flow, valid), (preds, upd)

    (loss, (preds, upd)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    jax_grads = from_jax_variables({"params": grads})
    _check_grads(jax_grads, setup["grads"], setup["grads32"])
    model = _port(setup)
    port_preds, port_stats = fast_train_forward(model, *_batch(setup)[:2])
    for got, want in zip(port_preds, preds):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-3, atol=2e-3)
    want_stats = from_jax_variables({"params": variables["params"],
                                     "batch_stats": upd})
    for k, v in port_stats.items():
        np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    port_loss, port_grads = _grads(model, port_preds, *_batch(setup)[2:])
    np.testing.assert_allclose(port_loss, float(loss), rtol=1e-4)
    _check_grads(port_grads, setup["grads"], setup["grads32"])


def _tiny_config(variant, tmp_path):
    cfg = load_config(ROOT / "configure" / f"stereo_net_config_{variant}.json")
    cfg.path = str(tmp_path / "exp")
    cfg.data.image_size = [32, 64]
    cfg.train.batch_size = 2
    cfg.train.fast_kernels = "on"
    return cfg


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_takes_two_kernel_path_steps_on_cpu(variant, tmp_path,
                                                  monkeypatch):
    """``train()`` on the repo's v2 and v3 configs (crop cut to 32 x 64,
    batch 2) takes two steps on the kernel path."""
    steps = []
    make_step = fast_train.make_fast_train_step

    def spy(*args, **kwargs):
        steps.append(kwargs.get("dtype"))
        return make_step(*args, **kwargs)

    import realtime_stereo_matcher_tpu_torch.train.trainer as trainer

    monkeypatch.setattr(trainer, "make_fast_train_step", spy)
    cfg = _tiny_config(variant, tmp_path)
    data = SyntheticBatches(2, (32, 64), n_batches=1, max_disp=16.0)
    seen = []
    path = train(cfg, max_steps=1, data_loader=data, device="cpu",
                 on_step=lambda s, m: seen.append(float(m["live_loss"])))
    assert steps == [torch.bfloat16]  # the kernel path, in the config's bf16
    assert len(seen) == 2 and all(np.isfinite(seen))
    assert torch.load(path, weights_only=True)["step"] == 2


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_fast_step_supported_takes_v1_v2_v3(variant, tmp_path):
    name = "" if variant == "v1" else f"_{variant}"
    cfg = load_config(ROOT / "configure" / f"stereo_net_config{name}.json")
    model = build_model(cfg.model.as_dict(), device="cpu")
    assert fast_step_supported(model, cfg)
    narrow = dict(cfg.model.as_dict(), parameters={"hidden_dim": 16})
    assert not fast_step_supported(build_model(narrow, device="cpu"), cfg)


def test_reference_initialize_redraws_the_up_projections():
    """v3's ConvTranspose2d weights and biases come from the train-start
    generator: the same seed gives the same values, another seed others,
    and they follow the JAX package's init in distribution (torch default
    uniform, fan-in out_channels x 2 x 2)."""
    spec = _spec("v3")
    flax_model = jax_build_model(spec)
    img = jnp.zeros((1, 16, 16, 3), jnp.float32)
    variables = jax.jit(lambda k: flax_model.init(k, img, img, train=True))(
        jax.random.PRNGKey(0))
    want = from_jax_variables(jax_reference_initialize(
        dict(variables), jax.random.PRNGKey(3),
        model_type="MobileStereoNetV3"))

    def drawn(seed):
        model = build_model(spec, device="cpu",
                            generator=torch.Generator().manual_seed(9))
        reference_initialize(model, torch.Generator().manual_seed(seed))
        return model.state_dict()

    a, b, other = drawn(5), drawn(5), drawn(6)
    built = build_model(spec, device="cpu",
                        generator=torch.Generator().manual_seed(9)).state_dict()
    keys = [k for k in a if ".up_conv.0." in k]
    assert len(keys) == 6  # weight and bias of three up-projections
    for k in keys:
        assert torch.equal(a[k], b[k]), k
        assert not torch.equal(a[k], other[k]), k
        assert not torch.equal(a[k], built[k]), k  # redrawn, not kept
        bound = 1.0 / np.sqrt(32 * 2 * 2)
        assert float(a[k].abs().max()) <= bound
        if k.endswith("weight"):  # 4096 draws: uniform's std, bound / sqrt 3
            ratio = float(a[k].std()) / float(want[k].std())
            assert abs(ratio - 1) < 0.1, (k, ratio)
            assert abs(float(a[k].mean())) < 0.1 * float(want[k].std()), k
