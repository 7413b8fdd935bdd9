"""The port's MobileDispNetC against the JAX package, on the CPU.

* Weights drawn by the port's seeded init, BatchNorm running stats
  randomised, moved to JAX with ``import_torch_state_dict``: the plain port
  in eval mode matches Flax ``MobileDispNetC.apply`` on all six heads within
  1e-3 px at 1 x 128 x 192 and at 1 x 120 x 180 (padded to 128 x 192 inside
  the model and cropped back), float32;
* ``disparity_regression`` and ``disparity_interpolate`` match the JAX
  package's within 1e-5;
* ``build_model`` builds DispNetC from every repo config that names it, with
  the reference's parameter count;
* a port state dict survives ``import_torch_state_dict`` and
  ``from_jax_variables`` exactly, both ways;
* the parameter groups and ``freeze`` of ``train/freeze.py`` give, by
  name, the labels of the JAX package's ``weight_bias_labels`` and
  ``freeze_labels``.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.models import disp_net_c as jdnc
from realtime_stereo_matcher_tpu.models.torch_import import (
    import_torch_state_dict,
)
from realtime_stereo_matcher_tpu.train.freeze import (
    freeze_labels as jax_freeze_labels,
    weight_bias_labels as jax_weight_bias_labels,
)
from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.models import MobileDispNetC, build_model
from realtime_stereo_matcher_tpu_torch.models import disp_net_c as tdnc
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.train.freeze import (
    freeze,
    freeze_labels,
    parameter_groups,
    weight_bias_labels,
)
from test_torch_port_v4_model import (  # noqa: F401 (fixture)
    one_torch_thread,
    randomize_bn,
    template,
    to_jax,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DNC_TYPE = "MobileDispNetC"
# the repo configs' model section
DNC = {"type": DNC_TYPE,
       "parameters": {"hidden_dim": 8, "max_disp": 192,
                      "with_batch_norm": True}}
CONFIGS = ("disp_net_c_config.json", "disp_net_c_synthetic_config.json",
           "disp_net_c_synthetic_100k_config.json",
           "disp_net_c_synthetic_100k_resume_config.json")


@pytest.fixture(scope="module")
def port_dnc():
    """The port's seeded DispNetC with randomised BN running stats, its
    Flax model and the same weights as JAX variables."""
    model = build_model(DNC, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    randomize_bn(model, 5)
    flax, shapes = template(DNC)
    return model, flax, shapes, to_jax(model, DNC, shapes)


@pytest.mark.parametrize("hw", [(128, 192), (120, 180)])
def test_plain_dispnetc_matches_flax(rng, port_dnc, hw):
    model, flax, _, variables = port_dnc
    left, right = (rng.uniform(0, 255, (1, *hw, 3)).astype(np.float32)
                   for _ in range(2))
    want = jax.jit(lambda v, a, b: flax.apply(v, a, b, train=False))(
        variables, left, right)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(left), torch.from_numpy(right))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, *hw, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-3)
    # unconstrained in sign
    assert float(got[-1].max()) > 0 > float(got[-1].min())


def test_disparity_regression_and_interpolate(rng):
    vol = rng.normal(size=(2, 24, 5, 7)).astype(np.float32)
    got = tdnc.disparity_regression(torch.from_numpy(vol), 24)
    want = jdnc.disparity_regression(jnp.asarray(vol), 24)
    assert got.shape == (2, 1, 5, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError):
        tdnc.disparity_regression(torch.from_numpy(vol), 23)
    disp = rng.normal(0, 3, size=(2, 4, 6, 1)).astype(np.float32)
    for out_hw in ((16, 24), (4, 6), (13, 20)):
        got = tdnc.disparity_interpolate(torch.from_numpy(disp), out_hw)
        want = jdnc.disparity_interpolate(jnp.asarray(disp), out_hw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("config", CONFIGS)
def test_build_model_from_the_repo_configs(config):
    cfg = load_config(ROOT / "configure" / config).model.as_dict()
    assert cfg == DNC
    model = build_model(cfg, device="cpu")
    assert type(model) is MobileDispNetC and not model.training
    assert sum(p.numel() for p in model.parameters()) == 2365448


def test_state_dict_round_trip(port_dnc):
    model, _, shapes, variables = port_dnc
    sd = model.state_dict()
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert back[k].shape == v.shape and torch.equal(back[k], v), k
    again = import_torch_state_dict(
        DNC_TYPE, {k: v.numpy() for k, v in back.items()}, shapes)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(variables)[0],
                            jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def _by_name(labels_tree, params_tree):
    """A JAX label tree carried to the port's parameter names: each label
    becomes a constant array of its leaf's shape, mapped by
    ``from_jax_variables``."""
    codes = {"weight": 1.0, "bias": 2.0, "frozen": 3.0}
    arrays = jax.tree_util.tree_map(
        lambda lbl, p: np.full(np.shape(p), codes[lbl], np.float32),
        labels_tree, params_tree)
    names = {v: k for k, v in codes.items()}
    return {k: names[float(v.flatten()[0])]
            for k, v in from_jax_variables({"params": arrays}).items()}


def test_parameter_groups_and_freeze_match_jax(port_dnc):
    model, _, _, variables = port_dnc
    params = variables["params"]
    want = _by_name(jax_weight_bias_labels(params), params)
    assert weight_bias_labels(model) == want
    assert {"weight", "bias"} == set(want.values())
    assert freeze_labels(model) == _by_name(jax_freeze_labels(params), params)
    assert set(freeze_labels(model, frozen=("bias",)).values()) == {
        "weight", "frozen"}
    groups = parameter_groups(model)
    assert [g["name"] for g in groups] == ["weight", "bias"]
    by_id = {id(p): n for n, p in model.named_parameters()}
    for g in groups:
        assert {want[by_id[id(p)]] for p in g["params"]} == {g["name"]}
    assert sum(len(g["params"]) for g in groups) == len(want)
    optim = torch.optim.SGD([dict(g, lr=lr) for g, lr in zip(groups,
                                                                (1.0, 2.0))])
    assert [g["lr"] for g in optim.param_groups] == [1.0, 2.0]

    frozen = build_model(DNC, device="cpu")
    freeze(frozen)
    assert not any(p.requires_grad for p in frozen.parameters())
    some = build_model(DNC, device="cpu")
    freeze(some, frozen=("bias",))
    assert all(p.requires_grad == (want[n] == "weight")
               for n, p in some.named_parameters())
