"""The port's sharded inference against one process and against the JAX
package, on the CPU.

Four gloo ranks (``tests/test_torch_port_sharded_worker.py`` run as a
script by ``spawn_ranks``; one spawn for the whole file) run every case of
``W.CASES`` (v1, v2, v3 and V4, plain and kernel path, float64 and float32,
64 x 96 and 52 x 90, over 2, 3 and 4 ranks); the same model's one-process
forward runs here:

* every rank of a case returns the one-process forward (float64 within
  1e-10, float32 within rtol 1e-4 / atol 1e-4, the JAX package's own
  tolerance for its sharded forward, tests/test_sharded_infer.py), every
  rank the same maps, and a rank outside the case's ranks None;
* the plain float32 sharded forward of each model equals the JAX package's
  ``model.apply`` on the same weights (``import_torch_state_dict``) within
  rtol 1e-4 / atol 1e-4;
* a rank's slab of the difference volume is the JAX package's
  ``_local_difference_slab``; the port's ``make_sharded_coarse_fn`` over 4
  ranks and
  ``make_sharded_v4_volume_fn`` over 4 ranks equal the JAX package's on its
  8-device CPU mesh, on the same weights and features, within 1e-5;
* a rank's row halo (``halo.exchange``) is its rows of the whole tensor
  with the halo rows, as ``halo.take_rows`` cuts them, for halos deeper
  than a shard, of one row and on one side, zero and edge filled;
* the collective audit of one sharded v1 frame: one all-gather a halo
  (each conv of the encoder and the refines, each 2x upsample, each filter
  layer), the two soft-argmin all-reduces, and the gathers of the coarse
  features and the three maps.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_port_sharded_worker as W
from realtime_stereo_matcher_tpu.models import build_model as jax_build_model
from realtime_stereo_matcher_tpu.models.stereo_net_v4 import InterweaveVolume
from realtime_stereo_matcher_tpu.models.torch_import import (
    import_torch_state_dict,
)
from realtime_stereo_matcher_tpu.parallel.disparity_sharding import (
    _local_difference_slab as jax_local_difference_slab,
    make_sharded_coarse_fn as jax_sharded_coarse_fn,
    make_sharded_v4_volume_fn as jax_sharded_v4_volume_fn,
)
from realtime_stereo_matcher_tpu_torch.ops import difference_cost_volume
from realtime_stereo_matcher_tpu_torch.parallel import halo
from realtime_stereo_matcher_tpu_torch.parallel.distributed import spawn_ranks
from realtime_stereo_matcher_tpu_torch.parallel.mesh import Axis

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = {"f64": dict(rtol=1e-10, atol=1e-10), "f32": dict(rtol=1e-4, atol=1e-4)}
# the plain float32 case of each model held to the JAX package
JAX_CASES = {"v1": "v1_plain_f32_even_r4", "v2": "v2_plain_f32_odd_r2",
             "v3": "v3_plain_f32_odd_r3", "v4": "v4_plain_f32_even_r4"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread, as each rank has (the suite's workers share the
    cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results (the worker's ``rank<r>.pt``)."""
    out = tmp_path_factory.mktemp("ranks")
    spawn_ranks([ROOT / "tests" / "test_torch_port_sharded_worker.py", out],
                W.WORLD, timeout=240, cwd=ROOT)
    return [torch.load(out / f"rank{r}.pt", weights_only=True)
            for r in range(W.WORLD)]


def _jax_variables(name: str, port_model, **overrides):
    """``W.MODELS[name]``'s Flax model and the port model's weights as its
    variables (float32)."""
    config = {"type": W.MODELS[name]["type"],
              "parameters": dict(W.MODELS[name]["parameters"], **overrides)}
    flax = jax_build_model(config)
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: flax.init(k, img, img, train=False),
                            jax.random.PRNGKey(0))
    sd = {k: v.float().numpy() for k, v in port_model.state_dict().items()}
    return flax, import_torch_state_dict(config["type"], sd, shapes)


@pytest.mark.parametrize("name", list(W.CASES))
def test_sharded_forward_equals_one_process(ranks, name):
    model, path, dt, size, n = W.CASES[name]
    want = W.one_process(name)
    first = ranks[0]["cases"][name]
    for r in range(W.WORLD):
        got = ranks[r]["cases"][name]
        if r >= n:
            assert got is None, (name, r)
            continue
        assert len(got) == len(want)
        for g, t, f in zip(got, want, first):
            assert g.shape == t.shape == (1, *W.SIZES[size], 1)
            assert g.dtype == t.dtype
            assert torch.equal(g, f), (name, r)
            torch.testing.assert_close(g, t, **TOL[dt])


@pytest.mark.parametrize("model", list(JAX_CASES))
def test_plain_sharded_forward_equals_jax(ranks, model):
    name = JAX_CASES[model]
    port = W.case_model(model, torch.float32)
    flax, variables = _jax_variables(model, port)
    left, right = W.frames(W.CASES[name][3])
    want = flax.apply(variables, jnp.asarray(left.numpy()),
                      jnp.asarray(right.numpy()), train=False)
    got = ranks[0]["cases"][name]
    assert len(got) == len(want)
    for g, t in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(t), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("d0", [0, 4, 12])
def test_difference_slab_equals_jax(d0):
    """A rank's slab of the difference volume, shifts [d0, d0 + 4)."""
    left, right = W.coarse_features()
    got = difference_cost_volume(left, right, 4, shift0=d0)
    want = jax_local_difference_slab(jnp.asarray(left.numpy()),
                                     jnp.asarray(right.numpy()), d0, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharded_coarse_equals_jax(ranks):
    port = W.case_model("v1", torch.float32)
    _, variables = _jax_variables("v1", port)
    left, right = (jnp.asarray(f.numpy()) for f in W.coarse_features())
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("disp",))
    fn = jax_sharded_coarse_fn(
        mesh, variables["params"]["CostFilter3D_0"],
        variables["batch_stats"]["CostFilter3D_0"], W.COARSE_D,
        hidden_dim=W.MODELS["v1"]["parameters"]["hidden_dim"])
    want = np.asarray(fn(left, right))
    for r in range(W.WORLD):
        got = ranks[r]["coarse"][..., 0].numpy()
        assert got.shape == want.shape == W.COARSE_FEAT[:3]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sharded_v4_volume_equals_jax(ranks):
    port = W.v4_volume_model()
    _, variables = _jax_variables("v4", port, volume_size=W.V4_SHIFTS)
    sub = {"params": variables["params"]["InterweaveVolume_0"],
           "batch_stats": variables["batch_stats"]["InterweaveVolume_0"]}
    fl, fr = (jnp.asarray(f.permute(0, 2, 3, 1).numpy())
              for f in W.v4_features())
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("disp",))
    want = np.asarray(jax_sharded_v4_volume_fn(
        mesh, InterweaveVolume(n_shifts=W.V4_SHIFTS), sub)(fl, fr))
    for r in range(W.WORLD):
        got = ranks[r]["v4_volume"].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fill,lo,hi", W.EXCHANGES)
def test_exchange_equals_take_rows(ranks, fill, lo, hi):
    full = W.exchange_source()
    for r in range(W.WORLD):
        want = halo.take_rows(full, Axis(None, r, W.WORLD), dim=1, lo=lo,
                              hi=hi, fill=fill)
        assert torch.equal(ranks[r]["exchange"][f"{fill}{lo}{hi}"], want), r


def test_audit_counts_every_collective_of_a_frame(ranks):
    """v1 at 64 x 96 over 4 ranks: 4 row shards, 4 disparity shards."""
    audit = ranks[0]["audit"]
    per = {k: v["count"] for k, v in audit["per_what"].items()}
    refine = 2 + 2 * len(W.MODELS["v1"]["parameters"]["refine_dilates"])
    encoder = 3 * 3 + 1  # 3 stages of (stride-2 conv, ResBlock), a head
    assert per == {"row halo": 2 * encoder + 3 * refine,
                   "coarse features": 2, "disparity halo": 5,
                   "soft-argmin max": 1, "soft-argmin sums": 1,
                   "resize halo": 3, "disparity maps": 3}
    assert set(audit["per_op"]) == {"all-gather", "all-reduce"}
    # a gathered piece is one shard: (1, 2, 12, 8) features, (1, 16, 96, 1)
    # maps, in float64
    assert audit["per_what"]["coarse features"]["bytes"] == 2 * 2 * 12 * 8 * 8
    assert audit["per_what"]["disparity maps"]["bytes"] == 3 * 16 * 96 * 8
    assert audit["total_bytes"] == sum(v["bytes"] for v in
                                       audit["per_op"].values())
