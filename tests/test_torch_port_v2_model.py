"""The port's MobileStereoNetV2 against the JAX package, on the CPU.

* Weights drawn by the port's seeded init, BatchNorm running stats
  randomised, moved to JAX with ``import_torch_state_dict``: the plain port
  v2 matches Flax ``MobileStereoNetV2.apply`` on all three heads within 2e-4
  absolute, the rule of tests/test_torch_parity.py;
* a Flax-initialised v2 moved into the port with ``from_jax_variables``
  matches within 5e-6 of each head's largest magnitude, the v1 bound;
* the kernel path's v2 RefineNet (``fast_refine`` with the right RGB,
  banded warp) matches Flax ``RefineNet(warp_guidance=True)`` at each level
  where the disparity lies inside the band, within ``_stack_atol`` of
  tests/test_torch_port_kernels.py (14 convs in float32 with the BatchNorm
  folded differently);
* the kernel path in float32 (the kernels' plain versions on the CPU)
  matches the plain port v2 with the same banded warp within rtol 1e-3,
  atol 5e-2 (tests/test_fast_infer.py), and in bfloat16 stays within 1 px
  median of float32;
* one kernel-path frame calls the kernels 56 (K1, three of them 7 -> 32),
  6 (K2) and 5 (K3) times, the counts ``chip_smoke.py`` asserts on the card;
* the trained checkpoint ``SYNTH_STEREO_NET_V2-epoch-44000.ckpt``, restored
  read-only by the JAX package's ``restore_checkpoint`` and moved into the
  port with ``from_jax_variables``, gives Flax's output within 2e-4 on a
  synthetic scene, and the port's kernel path gives its plain banded
  output within the kernel path's tolerance: ``convert.py`` on trained
  BatchNorm statistics.
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
from realtime_stereo_matcher_tpu.models.torch_import import (
    import_torch_state_dict,
)
from realtime_stereo_matcher_tpu_torch.data.synthetic import make_scene
from realtime_stereo_matcher_tpu_torch.kernels import conv3x3, cost_filter3d
from realtime_stereo_matcher_tpu_torch.kernels.refine_stack import (
    build_refine_plan,
    fast_refine,
)
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.models.fast_infer import make_fast_forward
from realtime_stereo_matcher_tpu_torch.models.stereo_net import (
    refine_max_shifts,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
V2_TYPE = "MobileStereoNetV2"
CHECKPOINT = (ROOT / "experiments" / "SYNTH_STEREO_NET_V2" / "checkpoints"
              / "SYNTH_STEREO_NET_V2-epoch-44000.ckpt")
# the config of the run that wrote CHECKPOINT (its save frequency is 4000)
CHECKPOINT_CONFIG = (ROOT / "configure"
                     / "stereo_net_v2_synthetic_56k_resume_config.json")


def _v2(max_disp=192):
    return {"type": V2_TYPE, "parameters": {"max_disp": max_disp}}


def _images(rng, hw):
    left = rng.uniform(0, 255, (1, *hw, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (1, *hw, 3)).astype(np.float32)
    return left, right


def _stack_atol(want):
    """The rule of tests/test_torch_port_kernels.py: 1e-4, or 5e-6 of the
    largest magnitude where that is larger."""
    return max(1e-4, 5e-6 * float(np.abs(np.asarray(want)).max()))


def _randomize_bn(model, seed):
    gen = np.random.default_rng(seed)
    for m in model.modules():
        if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
            n = m.running_mean.numel()
            m.running_mean.copy_(torch.from_numpy(
                gen.normal(0, 0.3, n).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                gen.uniform(0.5, 1.5, n).astype(np.float32)))


@pytest.fixture(scope="module")
def flax_template():
    """Flax-initialised v2 variables."""
    model = jax_build_model(_v2())
    img = jnp.zeros((1, 16, 16, 3), jnp.float32)
    return jax.jit(lambda k: model.init(k, img, img, train=False))(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_v2(flax_template):
    """The port's seeded v2 with randomised BN running stats, and the same
    weights as JAX variables."""
    model = build_model(_v2(), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    _randomize_bn(model, 5)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, import_torch_state_dict(V2_TYPE, sd, flax_template)


def _port_with(state_dict, max_disp=192):
    model = build_model(_v2(max_disp), device="cpu")
    model.load_state_dict(state_dict)
    return model


@pytest.mark.parametrize("max_disp,hw", [(63, (64, 128)), (192, (64, 128)),
                                         (192, (60, 125))])
def test_plain_v2_matches_flax(rng, port_v2, max_disp, hw):
    model, variables = port_v2
    model = _port_with(model.state_dict(), max_disp)
    left, right = _images(rng, hw)
    want = jax_build_model(_v2(max_disp)).apply(
        variables, jnp.asarray(left), jnp.asarray(right), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, *hw, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-4)
    assert float(got[-1].max()) <= 0.0


def test_from_jax_variables_v2_matches_flax(rng, flax_template):
    gen = np.random.default_rng(11)

    def randomize(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name == "mean":
            return gen.normal(0, 0.3, shape).astype(np.float32)
        if name == "var":
            return gen.uniform(0.5, 1.5, shape).astype(np.float32)
        return np.asarray(leaf)

    variables = jax.tree_util.tree_map_with_path(randomize, flax_template)
    sd = from_jax_variables(variables)
    assert sd["refine_layer.0.conv0.0.0.weight"].shape == (32, 7, 3, 3)
    model = _port_with(sd)
    left, right = _images(rng, (64, 128))
    want = jax_build_model(_v2()).apply(variables, jnp.asarray(left),
                                        jnp.asarray(right), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=5e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize("level", [0, 1, 2])
def test_fast_refine_v2_matches_flax(rng, port_v2, level):
    """In-band disparity: the banded warp equals Flax's full warp there.
    The guides are full-resolution RGB, resized to the level as in the
    model."""
    model, variables = port_v2
    max_shift = refine_max_shifts(192, 3)[level]
    h, w = 8, 40
    disp = rng.uniform(0, (max_shift - 2) / 2, (1, h, w, 1)).astype(np.float32)
    left = rng.uniform(-1, 1, (1, 8 * h, 8 * w, 3)).astype(np.float32)
    right = rng.uniform(-1, 1, (1, 8 * h, 8 * w, 3)).astype(np.float32)
    name = f"RefineNet_{level}"
    want = JaxRefineNet(32, (1, 2, 4, 8, 1, 1), warp_guidance=True).apply(
        {"params": variables["params"][name],
         "batch_stats": variables["batch_stats"][name]},
        jnp.asarray(disp), jnp.asarray(left), jnp.asarray(right))
    plan = build_refine_plan(model.refine_layer[level], dtype=torch.float32)
    assert plan.entry is None and len(plan.specs) == 14
    assert plan.specs[0].w.shape == (3, 3, 7, 32)
    got = fast_refine(torch.from_numpy(disp), torch.from_numpy(left), plan,
                      torch.from_numpy(right), max_shift)
    assert got.dtype == torch.float32 and got.shape == (1, 2 * h, 2 * w, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_stack_atol(want))


@pytest.mark.parametrize("hw", [(64, 128), (60, 125)])
def test_fast_forward_v2_f32_matches_plain(rng, port_v2, hw):
    model, _ = port_v2
    left, right = (torch.from_numpy(a) for a in _images(rng, hw))
    with torch.no_grad():
        want = model(left, right, banded_warp=True)
    got = make_fast_forward(model, dtype=torch.float32)(left, right)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=5e-2)
    assert float(got[-1].max()) <= 0.0


def test_fast_forward_v2_bf16_tracks_f32(rng, port_v2):
    model, _ = port_v2
    left, right = (torch.from_numpy(a) for a in _images(rng, (64, 128)))
    want = make_fast_forward(model, dtype=torch.float32)(left, right)[-1]
    got = make_fast_forward(model)(left, right)[-1]
    assert got.dtype == torch.float32
    err = (got - want).abs()
    assert float(err.median()) < 1.0, float(err.median())


def test_fast_forward_v2_calls_each_kernel_as_counted(rng, port_v2,
                                                      monkeypatch):
    """56 K1 (three of them 7 -> 32), 6 K2 and 5 K3 wrapper calls per
    frame: the launch counts that chip_smoke.py asserts on the card,
    counted here at the wrappers by (name, C_in, C_out)."""
    calls = {}

    def counting(fn):
        def wrapper(x, w, *args, **kwargs):
            name = ("fused_conv3d" if w.ndim == 5 else
                    conv3x3.KERNEL_NAMES[kwargs.get("stride", 1)])
            key = (name, w.shape[-2], w.shape[-1])
            calls[key] = calls.get(key, 0) + 1
            return fn(x, w, *args, **kwargs)
        return wrapper

    monkeypatch.setattr(conv3x3, "fused_conv3x3",
                        counting(conv3x3.fused_conv3x3))
    monkeypatch.setattr(cost_filter3d, "fused_conv3d",
                        counting(cost_filter3d.fused_conv3d))
    model, _ = port_v2
    left, right = (torch.from_numpy(a) for a in _images(rng, (64, 128)))
    make_fast_forward(model)(left, right)
    totals = {}
    for (name, _, _), n in calls.items():
        totals[name] = totals.get(name, 0) + n
    assert totals == {"fused_conv3x3": 56, "fused_conv3x3_s2": 6,
                      "fused_conv3d": 5}
    assert calls[("fused_conv3x3", 7, 32)] == 3


@pytest.mark.slow
def test_fast_forward_v2_matches_jax_kernel_path(rng, port_v2):
    """The port's v2 kernel path (plain versions on the CPU) against the JAX
    v2 kernel path with its Pallas kernels in interpret mode, float32, at
    64 x 256 (a size the JAX path's alignment pad leaves as it is), at the
    tolerances of tests/test_fast_infer.py."""
    from realtime_stereo_matcher_tpu.models.fast_infer import (
        make_fast_forward as jax_make_fast_forward,
    )

    model, variables = port_v2
    left, right = _images(rng, (64, 256))
    want = jax_make_fast_forward(jax_build_model(_v2()), variables,
                                 dtype=jnp.float32)(jnp.asarray(left),
                                                    jnp.asarray(right))
    got = make_fast_forward(model, dtype=torch.float32)(
        torch.from_numpy(left), torch.from_numpy(right))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=5e-2)


def test_v2_state_dict_round_trip(flax_template):
    """port state dict -> import_torch_state_dict -> from_jax_variables is
    the identity, tensor by tensor, under the reference key names."""
    model = build_model(_v2(), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    _randomize_bn(model, 4)
    sd = model.state_dict()
    jax_vars = import_torch_state_dict(
        V2_TYPE, {k: v.numpy() for k, v in sd.items()}, flax_template)
    back = from_jax_variables(jax_vars)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k].to(v.dtype), v), k
    for k in ("feature_extractor.0.0.weight", "cost_filter.12.bias",
              "refine_layer.2.conv0.0.0.weight",
              "refine_layer.1.conv0.7.weight"):
        assert k in sd, k


def test_trained_v2_checkpoint_gives_flax_output(tmp_path):
    """The committed trained v2, restored read-only by the JAX package and
    moved into the port: plain port vs Flax within 2e-4 on a synthetic
    scene, and the port's kernel path vs its plain banded model within the
    kernel path's tolerance (rtol 1e-3, atol 5e-2)."""
    from realtime_stereo_matcher_tpu.config import (
        load_config as jax_load_config,
    )
    from realtime_stereo_matcher_tpu.train.trainer import (
        create_train_state,
        restore_checkpoint,
    )

    if not CHECKPOINT.is_dir():
        pytest.fail(f"the committed checkpoint {CHECKPOINT} is missing")
    cfg = jax_load_config(CHECKPOINT_CONFIG)
    jax_model, _, _, template = create_train_state(cfg, sample_hw=(16, 16))
    state = restore_checkpoint(CHECKPOINT, template)
    assert int(state.step) == 44000
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    sd = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))
    model = build_model(cfg.model.as_dict(), device="cpu")
    model.load_state_dict(sd)

    left, right, disp, valid = make_scene(3, 64, 128, max_disp=24.0)
    left, right = left[None].astype(np.float32), right[None].astype(np.float32)
    want = jax_model.apply(variables, jnp.asarray(left), jnp.asarray(right),
                           train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right))
        banded = model(torch.from_numpy(left), torch.from_numpy(right),
                       banded_warp=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-4)
    # trained weights find the scene: the final head is a disparity map
    epe = np.abs(-got[-1][0, ..., 0].numpy() - disp)[valid > 0].mean()
    assert epe < 3.0, epe
    fast = make_fast_forward(model, dtype=torch.float32)(
        torch.from_numpy(left), torch.from_numpy(right))
    for g, w in zip(fast, banded):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=5e-2)
