"""The port's v1 model against the JAX package, on the CPU.

* Weights drawn by the port's own seeded init, BatchNorm running stats
  randomised, moved to JAX with the JAX package's ``import_torch_state_dict``:
  the port's plain ``MobileStereoNet`` matches Flax ``MobileStereoNet.apply``
  on all three heads within 2e-4 absolute, the setup and tolerance of
  tests/test_torch_parity.py (float32 sums in another order through ~30
  layers; measured <= 5.4e-5 here).
* A Flax-initialised v1 (BatchNorm randomised) moved into the port with
  ``from_jax_variables`` matches too.  Flax's lecun-normal init has 3x the
  weight variance of torch's default, so the heads reach ~300 px at 64x128
  and the float32 noise grows with them: the bound is 5e-6 of each head's
  largest magnitude (measured <= 1.9e-6 over 3 seeds and 2 sizes).
* The port's kernel path (``make_fast_forward``) in float32 on the CPU runs
  the kernels' plain versions and matches the port's plain model within
  1e-4 (BatchNorm folded into scale/bias rounds differently; measured
  <= 4.6e-5); in bfloat16 its median error against float32 stays under 1 px.
* A port state dict survives the JAX package's ``import_torch_state_dict``
  and ``from_jax_variables`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.models import build_model as jax_build_model
from realtime_stereo_matcher_tpu.models.torch_import import (
    import_torch_state_dict,
)
from realtime_stereo_matcher_tpu_torch.models import (
    MobileDispNetC,
    MobileStereoNetV4,
    build_model,
)
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.models.fast_infer import make_fast_forward
from realtime_stereo_matcher_tpu_torch.models.stereo_net import (
    MobileStereoNetV2,
    MobileStereoNetV3,
    RefineNet,
)

V1 = {"type": "MobileStereoNet", "parameters": {}}


def _v1(max_disp=192):
    return {"type": "MobileStereoNet", "parameters": {"max_disp": max_disp}}


def _images(rng, hw):
    left = rng.uniform(0, 255, (1, *hw, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (1, *hw, 3)).astype(np.float32)
    return left, right


@pytest.fixture(scope="module")
def flax_template():
    """Flax-initialised v1 variables."""
    model = jax_build_model(V1)
    img = jnp.zeros((1, 16, 16, 3), jnp.float32)
    return jax.jit(lambda k: model.init(k, img, img, train=False))(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_v1(flax_template):
    """The port's seeded v1 with randomised BN running stats (as
    tests/test_torch_parity.py randomises them), and the same weights as
    JAX variables."""
    model = build_model(V1, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    gen = np.random.default_rng(5)
    for m in model.modules():
        if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
            n = m.running_mean.numel()
            m.running_mean.copy_(torch.from_numpy(
                gen.normal(0, 0.3, n).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                gen.uniform(0.5, 1.5, n).astype(np.float32)))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, import_torch_state_dict("MobileStereoNet", sd, flax_template)


def _port_with(state_dict, max_disp=192):
    model = build_model(_v1(max_disp), device="cpu")
    model.load_state_dict(state_dict)
    return model


@pytest.mark.parametrize("max_disp,hw", [(63, (64, 128)), (192, (64, 128)),
                                         (192, (60, 125))])
def test_plain_model_matches_flax(rng, port_v1, max_disp, hw):
    model, variables = port_v1
    model = _port_with(model.state_dict(), max_disp)
    left, right = _images(rng, hw)
    want = jax_build_model(_v1(max_disp)).apply(
        variables, jnp.asarray(left), jnp.asarray(right), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, *hw, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-4)
    assert float(got[-1].max()) <= 0.0


def test_from_jax_variables_matches_flax(rng, flax_template):
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
    want = jax_build_model(V1).apply(variables, jnp.asarray(left),
                                     jnp.asarray(right), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(left), torch.from_numpy(right))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=5e-6 * float(np.abs(w).max()))


def test_fast_forward_f32_matches_plain(rng, port_v1):
    model, _ = port_v1
    left, right = (torch.from_numpy(a) for a in _images(rng, (64, 128)))
    with torch.no_grad():
        want = model(left, right)
    got = make_fast_forward(model, dtype=torch.float32)(left, right)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4)
    assert float(got[-1].max()) <= 0.0


def test_fast_forward_bf16_tracks_f32(rng, port_v1):
    model, _ = port_v1
    left, right = (torch.from_numpy(a) for a in _images(rng, (64, 128)))
    with torch.no_grad():
        want = model(left, right)[-1]
    got = make_fast_forward(model)(left, right)[-1]
    assert got.dtype == torch.float32
    err = (got - want).abs()
    assert float(err.median()) < 1.0, float(err.median())


@pytest.mark.slow
def test_fast_forward_matches_jax_kernel_path(rng, port_v1):
    """The port's kernel path (plain versions on the CPU) against the JAX
    kernel path with its Pallas kernels in interpret mode, float32, at the
    tolerances of tests/test_fast_infer.py."""
    from realtime_stereo_matcher_tpu.models.fast_infer import (
        make_fast_forward as jax_make_fast_forward,
    )

    model, variables = port_v1
    left, right = _images(rng, (48, 256))
    want = jax_make_fast_forward(jax_build_model(V1), variables,
                                 dtype=jnp.float32)(jnp.asarray(left),
                                                    jnp.asarray(right))
    got = make_fast_forward(model, dtype=torch.float32)(
        torch.from_numpy(left), torch.from_numpy(right))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=5e-2)


def test_state_dict_round_trip(flax_template):
    """port state dict -> import_torch_state_dict -> from_jax_variables is
    the identity, tensor by tensor."""
    model = build_model(V1, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    for m in model.modules():
        if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
            for t in (m.weight, m.bias, m.running_mean, m.running_var):
                t.data = torch.rand(t.shape, generator=gen) + 0.5
    sd = model.state_dict()
    jax_vars = import_torch_state_dict(
        "MobileStereoNet", {k: v.numpy() for k, v in sd.items()}, flax_template)
    back = from_jax_variables(jax_vars)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k].to(v.dtype), v), k


def test_state_dict_names_are_the_reference_layout():
    keys = set(build_model(V1, device="cpu").state_dict())
    for k in ("feature_extractor.0.0.weight", "feature_extractor.1.conv.1.1.running_var",
              "feature_extractor.6.bias", "cost_filter.9.weight",
              "cost_filter.10.running_mean", "cost_filter.12.bias",
              "refine_layer.2.conv0.0.0.weight",
              "refine_layer.0.conv0.6.conv.0.1.weight",
              "refine_layer.1.conv0.7.weight"):
        assert k in keys, k


def test_build_model_is_seeded():
    def weights(seed):
        return build_model(V1, device="cpu", generator=torch.Generator()
                           .manual_seed(seed)).state_dict()["cost_filter.0.weight"]

    assert torch.equal(weights(1), weights(1))
    assert not torch.equal(weights(1), weights(2))


@pytest.mark.parametrize("mtype", ["MobileStereoNetV2", "MobileStereoNetV4",
                                   "MobileDispNetC", "OpenCVSGBMModule"])
def test_unported_types_name_the_roadmap(mtype):
    """Each type the port does not have raises naming ROADMAP.md.  v2, V4
    and DispNetC were among them until they were ported: their cases check
    that they left the queue and build."""
    ported = {"MobileStereoNetV2": MobileStereoNetV2,
              "MobileStereoNetV4": MobileStereoNetV4,
              "MobileDispNetC": MobileDispNetC}
    if mtype in ported:
        model = build_model({"type": mtype, "parameters": {}}, device="cpu")
        assert type(model) is ported[mtype] and not model.training
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model({"type": mtype, "parameters": {}}, device="cpu")


def test_v3_is_ported():
    """MobileStereoNetV3 builds from the repo's v3 config, in eval mode."""
    import json
    import pathlib

    cfg = json.loads((pathlib.Path(__file__).resolve().parent.parent
                      / "configure" / "stereo_net_config_v3.json").read_text())
    model = build_model(cfg["model"], device="cpu")
    assert type(model) is MobileStereoNetV3 and not model.training
    assert (model.down_factor, model.max_disp, model.hidden_dim) == (3, 192, 32)
    assert model.refine_dilates == (1, 2, 4, 8, 1, 1)


def test_unknown_type_raises():
    with pytest.raises(NotImplementedError, match="not a model type"):
        build_model({"type": "NoSuchNet"}, device="cpu")


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert next(build_model(V1).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(V1)


def test_fast_forward_takes_v1_and_v3_only():
    """The kernel path takes v1, v2 and v3 (v2 since it was ported) and
    raises naming ROADMAP.md on anything else."""
    with pytest.raises(NotImplementedError,
                       match="v1, v2 and v3.*ROADMAP.md"):
        make_fast_forward(RefineNet())
    for mtype in ("MobileStereoNetV2", "MobileStereoNetV3"):
        model = build_model({"type": mtype, "parameters": {}}, device="cpu")
        assert callable(make_fast_forward(model))


def test_v2_still_raises():
    """v2 was queued until it was ported: it now builds from the repo's v2
    config in eval mode, and the type still in the queue (the classical
    SGBM; V4 and DispNetC have left it too) raises."""
    import json
    import pathlib

    cfg = json.loads((pathlib.Path(__file__).resolve().parent.parent
                      / "configure" / "stereo_net_config_v2.json").read_text())
    model = build_model(cfg["model"], device="cpu")
    assert type(model) is MobileStereoNetV2 and not model.training
    assert (model.down_factor, model.max_disp, model.hidden_dim,
            model.refine_dim) == (3, 192, 32, 7)
    assert model.refine_dilates == (1, 2, 4, 8, 1, 1)
    with pytest.raises(NotImplementedError, match="queued in ROADMAP.md"):
        build_model({"type": "OpenCVSGBMModule", "parameters": {}},
                    device="cpu")
