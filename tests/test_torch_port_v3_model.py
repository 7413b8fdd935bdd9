"""The port's MobileStereoNetV3 against the JAX package, on the CPU.

* Weights drawn by the port's seeded init, BatchNorm running stats
  randomised, moved to JAX with ``import_torch_state_dict``: the plain port
  v3 matches Flax ``MobileStereoNetV3.apply`` on all three heads within 2e-4
  absolute, the tolerance of the v1 check (measured <= 3.1e-5);
* a Flax-initialised v3 moved into the port with ``from_jax_variables``
  matches within 5e-6 of each head's largest magnitude, the v1 bound;
* the kernel path's U-Net (``fast_unet``) matches Flax
  ``UNetFeatureExtractor`` at 64 x 256 on all four levels within 2e-4, and
  its v3 RefineNet (``fast_refine`` with the right features, banded warp)
  matches Flax ``RefineNet(warp_guidance=True)`` on the 65-channel entry
  where the disparity lies inside the band, within 1e-4 (15 convs in
  float32 with the BatchNorm folded differently);
* the kernel path in float32 (the kernels' plain versions on the CPU)
  matches the plain port with the same banded warp within 1e-4, and in
  bfloat16 stays within 1 px median;
* one kernel-path frame calls the kernels 69 (K1), 6 (K2-4x4) and 5 (K3)
  times, the counts ``chip_smoke.py`` asserts on the card;
* a port state dict survives ``import_torch_state_dict`` and
  ``from_jax_variables`` exactly, under the reference key names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.models import build_model as jax_build_model
from realtime_stereo_matcher_tpu.models.stereo_net import (
    RefineNet as JaxRefineNet,
    UNetFeatureExtractor as JaxUNet,
)
from realtime_stereo_matcher_tpu.models.torch_import import (
    import_torch_state_dict,
)
from realtime_stereo_matcher_tpu_torch.kernels import (
    conv3x3,
    cost_filter3d,
)
from realtime_stereo_matcher_tpu_torch.kernels.refine_stack import (
    build_refine_plan,
    fast_refine,
)
from realtime_stereo_matcher_tpu_torch.kernels.unet import (
    build_unet_plan,
    fast_unet,
)
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.models.fast_infer import make_fast_forward
from realtime_stereo_matcher_tpu_torch.parallel import halo
from realtime_stereo_matcher_tpu_torch.models.stereo_net import (
    refine_max_shifts,
)

V3_TYPE = "MobileStereoNetV3"


def _v3(max_disp=192):
    return {"type": V3_TYPE, "parameters": {"max_disp": max_disp}}


def _images(rng, hw):
    left = rng.uniform(0, 255, (1, *hw, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (1, *hw, 3)).astype(np.float32)
    return left, right


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
    """Flax-initialised v3 variables."""
    model = jax_build_model(_v3())
    img = jnp.zeros((1, 16, 16, 3), jnp.float32)
    return jax.jit(lambda k: model.init(k, img, img, train=False))(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_v3(flax_template):
    """The port's seeded v3 with randomised BN running stats, and the same
    weights as JAX variables."""
    model = build_model(_v3(), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    _randomize_bn(model, 5)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, import_torch_state_dict(V3_TYPE, sd, flax_template)


def _port_with(state_dict, max_disp=192):
    model = build_model(_v3(max_disp), device="cpu")
    model.load_state_dict(state_dict)
    return model


@pytest.mark.parametrize("max_disp,hw", [(63, (64, 128)), (192, (64, 128)),
                                         (192, (60, 125))])
def test_plain_v3_matches_flax(rng, port_v3, max_disp, hw):
    model, variables = port_v3
    model = _port_with(model.state_dict(), max_disp)
    left, right = _images(rng, hw)
    want = jax_build_model(_v3(max_disp)).apply(
        variables, jnp.asarray(left), jnp.asarray(right), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, *hw, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-4)
    assert float(got[-1].max()) <= 0.0


def test_from_jax_variables_v3_matches_flax(rng, flax_template):
    gen = np.random.default_rng(11)

    def randomize(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name == "mean":
            return gen.normal(0, 0.3, shape).astype(np.float32)
        if name == "var":
            return gen.uniform(0.5, 1.5, shape).astype(np.float32)
        return np.asarray(leaf)

    variables = jax.tree_util.tree_map_with_path(randomize, flax_template)
    model = _port_with(from_jax_variables(variables))
    left, right = _images(rng, (64, 128))
    want = jax_build_model(_v3()).apply(variables, jnp.asarray(left),
                                        jnp.asarray(right), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=5e-6 * float(np.abs(w).max()))


def test_fast_unet_matches_flax(rng, port_v3):
    model, variables = port_v3
    x = rng.uniform(-1, 1, (1, 64, 256, 3)).astype(np.float32)
    want = JaxUNet(hidden_dims=(32,) * 4).apply(
        {"params": variables["params"]["UNetFeatureExtractor_0"]},
        jnp.asarray(x))
    plan = build_unet_plan(model.feature_extractor, dtype=torch.float32)
    got = fast_unet(torch.from_numpy(x), plan)
    assert len(got) == len(want) == 4
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (1, 64 >> (3 - k), 256 >> (3 - k), 32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_fast_refine_warped_matches_flax(rng, port_v3, level):
    """In-band disparity: the banded warp equals Flax's full warp there."""
    model, variables = port_v3
    max_shift = refine_max_shifts(192, 3)[level]
    h, w = 8, 40
    disp = rng.uniform(0, (max_shift - 2) / 2, (1, h, w, 1)).astype(np.float32)
    l_f = rng.normal(size=(1, 2 * h, 2 * w, 32)).astype(np.float32)
    r_f = rng.normal(size=(1, 2 * h, 2 * w, 32)).astype(np.float32)
    name = f"RefineNet_{level}"
    want = JaxRefineNet(32, (1, 2, 4, 8, 1, 1), warp_guidance=True).apply(
        {"params": variables["params"][name],
         "batch_stats": variables["batch_stats"][name]},
        jnp.asarray(disp), jnp.asarray(l_f), jnp.asarray(r_f))
    plan = build_refine_plan(model.refine_layers[level], dtype=torch.float32)
    assert plan.entry is not None and len(plan.specs) == 13
    got = fast_refine(torch.from_numpy(disp), torch.from_numpy(l_f), plan,
                      torch.from_numpy(r_f), max_shift)
    assert got.dtype == torch.float32 and got.shape == (1, 2 * h, 2 * w, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("hw", [(64, 128), (60, 125)])
def test_fast_forward_v3_f32_matches_plain(rng, port_v3, hw):
    model, _ = port_v3
    left, right = (torch.from_numpy(a) for a in _images(rng, hw))
    with torch.no_grad():
        want = model(left, right, banded_warp=True)
    got = make_fast_forward(model, dtype=torch.float32)(left, right)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4)
    assert float(got[-1].max()) <= 0.0


def test_fast_forward_v3_bf16_tracks_f32(rng, port_v3):
    model, _ = port_v3
    left, right = (torch.from_numpy(a) for a in _images(rng, (64, 128)))
    with torch.no_grad():
        want = model(left, right, banded_warp=True)[-1]
    got = make_fast_forward(model)(left, right)[-1]
    assert got.dtype == torch.float32
    err = (got - want).abs()
    assert float(err.median()) < 1.0, float(err.median())


def test_fast_forward_v3_calls_each_kernel_as_counted(rng, port_v3,
                                                      monkeypatch):
    """69 K1, 6 K2-4x4 and 5 K3 wrapper calls per frame: the launch counts
    that chip_smoke.py asserts on the card, counted here at the wrappers."""
    calls = {}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(conv3x3, "fused_conv3x3", counting(
        "fused_conv3x3", conv3x3.fused_conv3x3))
    monkeypatch.setattr(halo, "fused_conv4x4_s2", counting(
        "fused_conv4x4_s2", conv3x3.fused_conv4x4_s2))
    monkeypatch.setattr(cost_filter3d, "fused_conv3d", counting(
        "fused_conv3d", cost_filter3d.fused_conv3d))
    model, _ = port_v3
    left, right = (torch.from_numpy(a) for a in _images(rng, (64, 128)))
    make_fast_forward(model)(left, right)
    assert calls == {"fused_conv3x3": 69, "fused_conv4x4_s2": 6,
                     "fused_conv3d": 5}


@pytest.mark.slow
def test_fast_forward_v3_matches_jax_kernel_path(rng, port_v3):
    """The port's v3 kernel path (plain versions on the CPU) against the JAX
    v3 kernel path with its Pallas kernels in interpret mode, float32, at
    64 x 256 (a size the JAX path's alignment pad leaves as it is), at the
    tolerances of tests/test_fast_infer.py."""
    from realtime_stereo_matcher_tpu.models.fast_infer import (
        make_fast_forward as jax_make_fast_forward,
    )

    model, variables = port_v3
    left, right = _images(rng, (64, 256))
    want = jax_make_fast_forward(jax_build_model(_v3()), variables,
                                 dtype=jnp.float32)(jnp.asarray(left),
                                                    jnp.asarray(right))
    got = make_fast_forward(model, dtype=torch.float32)(
        torch.from_numpy(left), torch.from_numpy(right))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=5e-2)


def test_v3_state_dict_round_trip(flax_template):
    """port state dict -> import_torch_state_dict -> from_jax_variables is
    the identity, tensor by tensor (ConvTranspose taps included)."""
    model = build_model(_v3(), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            for t in (m.weight, m.bias, m.running_mean, m.running_var):
                t.data = torch.rand(t.shape, generator=gen) + 0.5
    sd = model.state_dict()
    jax_vars = import_torch_state_dict(
        V3_TYPE, {k: v.numpy() for k, v in sd.items()}, flax_template)
    back = from_jax_variables(jax_vars)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k].to(v.dtype), v), k


def test_v3_state_dict_names_are_the_reference_layout():
    keys = set(build_model(_v3(), device="cpu").state_dict())
    for k in ("feature_extractor.down_layers.0.0.weight",
              "feature_extractor.down_layers.1.2.bias",
              "feature_extractor.down_layers.3.6.weight",
              "feature_extractor.up_layers.0.up_conv.0.weight",
              "feature_extractor.up_layers.2.merge_conv.4.bias",
              "cost_filter.12.bias",
              "refine_layers.0.conv0.0.0.weight",
              "refine_layers.2.conv0.6.conv.1.1.running_var",
              "refine_layers.1.conv0.7.weight"):
        assert k in keys, k
    assert keys.isdisjoint({"refine_layer.0.conv0.0.0.weight"})
    w = build_model(_v3(), device="cpu").state_dict()[
        "refine_layers.0.conv0.0.0.weight"]
    assert w.shape == (32, 65, 3, 3)
