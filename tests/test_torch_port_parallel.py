"""The port's data-parallel training against one process and against the
JAX package, on the CPU.

Two gloo ranks (``tests/test_torch_port_parallel_worker.py`` run as a
script by ``spawn_ranks``; one spawn for the whole file) each take half of
a seeded global batch; the same port step runs here in one process on the
whole batch:

* float64 (v1's kernel step with the kernels' plain versions, and the
  plain steps of v1, V4 with its GroupedBatchNorm2d and MobileDispNetC):
  loss and masked metrics within 1e-12 relative, every gradient within
  1e-10 relative L2 (a gradient under 1e-8 of the step's gradient norm,
  zero by symmetry, within 1e-10 of that norm instead), running stats and
  the updated parameters within 1e-12 / 1e-10; the ranks' parameters hash
  equal (rank 1 starts from other weights, so the broadcast from rank 0
  is held too);
* the plain steps of v1 and V4 (its GroupedBatchNorm2d) against the JAX
  package's Flax step (``apply(..., train=True, mutable=["batch_stats"])``
  and ``jax.grad`` of its ``sequence_loss``), float32, on the same weights
  and global batch sharded over 2 CPU devices: the ranks' float64 loss
  within 1e-5 relative, their gradients and running stats against a
  float32 floor, the JAX step on the batch reversed (a gradient's relative
  L2 within max(1e-4, 16 x its floor) and the median over tensors of error
  / floor at most 1.5; a running stat within max(1e-5, 6 x its floor), as
  tests/test_torch_port_v4_train.py holds V4's step); a gradient zero by
  symmetry (under 1e-8 of the step's gradient norm) within 1e-5 of that
  norm;
* float32 kernel step: the JAX package's own tolerances for its sharded
  step (tests/test_fast_train.py:318-340): loss rtol 1e-5, EPE 1e-4,
  parameters rtol 1e-3 / atol 2e-4, running stats rtol 1e-4 / atol 1e-5;
* the collective audit of that step: one gradient all-reduce of exactly 4
  bytes a parameter, one all-reduce of (2C + 1) float32 BatchNorm sums per
  BatchNorm application (the encoder's twice, left and right) and its
  backward; ``ring_wire_bytes`` equal to the JAX package's;
* ``sequence_loss`` and ``flow_map_metrics`` across the ranks, valid masks
  of unequal density, against the JAX package's under ``shard_map`` on a
  2-device slice of the 8-device CPU mesh (the global mean, and min / max
  over each shard's first image), within 1e-6 relative.

Without processes: the loader's shards and ``fetch_dataloader``'s split of
the global batch against the JAX loader's; ``ShardedResidentScenes``' index
streams against the JAX package's per-device segments; the ranks' rows of
the on-device augmentation against the one-process batch.
"""

import pathlib

import json

import jax
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import test_torch_port_parallel_worker as W
from realtime_stereo_matcher_tpu.config import load_config as jax_load_config
from realtime_stereo_matcher_tpu.data.device_cache import (
    ShardedResidentScenes as JaxShardedResidentScenes,
)
from realtime_stereo_matcher_tpu.data.loader import (
    StereoDataLoader as JaxStereoDataLoader,
    fetch_dataloader as jax_fetch_dataloader,
)
from realtime_stereo_matcher_tpu.data.synthetic import (
    SyntheticStereo as JaxSyntheticStereo,
)
from realtime_stereo_matcher_tpu.models import build_model as jax_build_model
from realtime_stereo_matcher_tpu.models.torch_import import (
    import_torch_state_dict,
)
from realtime_stereo_matcher_tpu.parallel.comm_audit import (
    ring_wire_bytes as jax_ring_wire_bytes,
)
from realtime_stereo_matcher_tpu.parallel.mesh import make_mesh as jax_make_mesh
from realtime_stereo_matcher_tpu.train.loss import (
    flow_map_metrics as jax_flow_map_metrics,
    sequence_loss as jax_sequence_loss,
)
from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.data.device_augment import (
    AugmentSpec,
    make_device_augment,
)
from realtime_stereo_matcher_tpu_torch.data.device_cache import (
    ShardedResidentScenes,
)
from realtime_stereo_matcher_tpu_torch.data.loader import (
    StereoDataLoader,
    fetch_dataloader,
)
from realtime_stereo_matcher_tpu_torch.data.synthetic import SyntheticStereo
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.parallel.comm_audit import ring_wire_bytes
from realtime_stereo_matcher_tpu_torch.parallel.distributed import spawn_ranks

ROOT = pathlib.Path(__file__).resolve().parent.parent
F64_CASES = [n for n, c in W.CASES.items() if c[2] == torch.float64]
# metrics a step reports of the global batch; min / max are the extremes of
# each rank's first image (held in test_loss_and_metrics_match_jax)
MEANS = ("epe", "0.5px", "1px", "3px", "5px", "live_loss")
# the plain steps held to the JAX package's batch-sharded Flax step
JAX_CASES = ("plain_f64", "v4_plain_f64")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread, as each rank has: under the suite's parallel
    workers, a step spread over every core slows every worker to a
    crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results (the worker's ``rank<r>.pt``)."""
    out = tmp_path_factory.mktemp("ranks")
    spawn_ranks([ROOT / "tests" / "test_torch_port_parallel_worker.py", out],
                W.WORLD, timeout=240, cwd=ROOT)
    return [torch.load(out / f"rank{r}.pt", weights_only=True)
            for r in range(W.WORLD)]


@pytest.fixture(scope="module")
def single():
    """Every case's step in this process on the global batch."""
    torch.manual_seed(0)
    results = {}
    for name in W.CASES:
        cfg, state = W.case_state(name)
        step_fn = W.case_step(name, cfg, state, None)
        results[name] = W.run_step(step_fn, state, W.case_batch(name))
    return results


def _jax_sharded_step(name, batches) -> list:
    """The JAX package's plain train-mode step on case ``name``'s weights
    (rank 0's, which the ranks start from) for each global batch, sharded
    over 2 CPU devices: (loss, gradients, new running stats) by the port's
    names, float64."""
    config = json.loads((W.CONFIGURE / W.CASES[name][0]).read_text())
    loss_params = config["train"]["loss"]["parameters"]
    _, state = W.case_state(name)
    flax = jax_build_model(config["model"])
    img = np.zeros((1, *W.CASES[name][4], 3), np.float32)
    shapes = jax.eval_shape(lambda k: flax.init(k, img, img, train=False),
                            jax.random.PRNGKey(0))
    variables = import_torch_state_dict(
        config["model"]["type"],
        {k: v.float().numpy() for k, v in state.model.state_dict().items()},
        shapes)
    mesh = jax_make_mesh(data=2, spatial=1, devices=jax.devices()[:2])

    @jax.jit
    def step(params, batch_stats, left, right, flow, valid):
        def loss_fn(p):
            preds, upd = flax.apply({"params": p, "batch_stats": batch_stats},
                                    left, right, train=True,
                                    mutable=["batch_stats"])
            return jax_sequence_loss(preds, flow, valid, **loss_params), upd

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    out = []
    for batch in batches:
        sharded = [jax.device_put(a, NamedSharding(mesh, P("data")))
                   for a in batch]
        (loss, upd), grads = step(variables["params"],
                                  variables["batch_stats"], *sharded)
        grads = from_jax_variables({"params": jax.tree_util.tree_map(
            np.asarray, grads)})
        stats = from_jax_variables({"params": variables["params"],
                                    "batch_stats": upd["batch_stats"]})
        out.append((float(loss), {k: v.double() for k, v in grads.items()},
                    {k: v.double() for k, v in stats.items()
                     if k.endswith(("running_mean", "running_var"))}))
    return out


@pytest.fixture(scope="module")
def jax_sharded():
    """Each of ``JAX_CASES``: the JAX step on its global batch, and on the
    batch reversed (the floor)."""
    out = {}
    for name in JAX_CASES:
        batch = W.case_batch(name)
        out[name] = _jax_sharded_step(
            name, [batch, [np.ascontiguousarray(a[::-1]) for a in batch]])
    return out


def _assert_grads(got, want, rtol, what):
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in want.values())))
    assert set(got) == set(want), what
    for k, w in want.items():
        err = float((got[k].double() - w.double()).norm())
        wn = float(w.double().norm())
        if wn >= 1e-8 * norm:
            assert err <= rtol * wn, f"{what} {k}: rel L2 {err / wn:.3e}"
        else:
            assert err <= rtol * norm, f"{what} {k}: {err:.3e} of {norm:.3e}"


@pytest.mark.multiprocess
def test_ranks_hash_equal_over_gloo(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert {r["backend"] for r in ranks} == {"gloo"}
    for name in W.CASES:
        assert ranks[0][name]["hash"] == ranks[1][name]["hash"], name


@pytest.mark.multiprocess
@pytest.mark.parametrize("name", F64_CASES)
def test_float64_step_matches_one_process(ranks, single, name):
    want = single[name]
    for r in ranks:
        got = r[name]
        for k in MEANS:
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                       rtol=1e-12, err_msg=f"{name} {k}")
        _assert_grads(got["grads"], want["grads"], 1e-10, name)
        for k, v in want["stats"].items():
            torch.testing.assert_close(got["stats"][k], v, rtol=1e-12,
                                       atol=1e-12, msg=f"{name} {k}")
        for k, v in want["params"].items():
            torch.testing.assert_close(got["params"][k], v, rtol=1e-10,
                                       atol=1e-12, msg=f"{name} {k}")


@pytest.mark.multiprocess
@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_step_matches_jax_sharded(ranks, jax_sharded, name):
    (loss, want, stats), (_, floor, floor_stats) = jax_sharded[name]
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["metrics"]["live_loss"], loss,
                                   rtol=1e-5)
        # V4's Conv3d biases have no JAX counterpart (folded away)
        assert set(want) <= set(got["grads"]), name
        norm = float(torch.sqrt(sum((got["grads"][k].double() ** 2).sum()
                                    for k in want)))
        ratios = []
        for k, w in want.items():
            g = got["grads"][k].double()
            err = float((w - g).norm())
            gn = float(g.norm())
            if gn < 1e-8 * norm:  # zero by symmetry
                assert err <= 1e-5 * norm, (name, k, err, norm)
                continue
            rel = err / gn
            rel_floor = float((floor[k] - g).norm()) / gn
            assert rel <= max(1e-4, 16 * rel_floor), (name, k, rel,
                                                      rel_floor)
            ratios.append(rel / max(rel_floor, 1e-4))
        assert float(np.median(ratios)) <= 1.5, (name, np.median(ratios))
        assert set(stats) == set(got["stats"]), name
        for k, v in stats.items():
            want_s = got["stats"][k].double()
            err = float((v - want_s).abs().max())
            lim = max(1e-5, 6 * float((floor_stats[k] - want_s).abs().max()))
            assert err <= lim, (name, k, err, lim)


@pytest.mark.multiprocess
def test_float32_kernel_step_matches_one_process(ranks, single):
    want = single["kernel_f32"]
    for r in ranks:
        got = r["kernel_f32"]
        np.testing.assert_allclose(got["metrics"]["live_loss"],
                                   want["metrics"]["live_loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["epe"],
                                   want["metrics"]["epe"], rtol=1e-4)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                       rtol=1e-3, atol=2e-4, err_msg=k)
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.multiprocess
def test_comm_audit_of_the_kernel_step(ranks):
    cfg, state = W.case_state("kernel_f32")
    model = state.model
    # BatchNorm applications a step: the encoder's on each view
    bns = [k for k, m in model.named_modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    applications = sum(2 if k.startswith("feature_extractor.") else 1
                       for k in bns)
    n_params = sum(p.numel() for p in model.parameters())
    for r in ranks:
        report = r["audit"]
        assert r["audit_params"] == n_params
        per_what = report["per_what"]
        assert per_what["gradients"] == {"count": 1, "bytes": 4 * n_params}
        sums = [i for i in report["inventory"]
                if i["what"] == "batch-norm sums"]
        assert len(sums) == applications == 61
        assert all(i["dtype"] == "float32" and i["shape"] == (65,)
                   and i["bytes"] == 65 * 4 for i in sums)
        assert per_what["batch-norm sums (backward)"] == per_what[
            "batch-norm sums"]
        assert report["per_op"]["all-reduce"]["count"] == len(
            report["inventory"])
        assert report["total_bytes"] == sum(
            v["bytes"] for v in report["per_op"].values())
        # the loss count, the live loss, and the metrics' sums and extremes
        assert {k: v["count"] for k, v in per_what.items()
                if k not in ("gradients",) and "batch-norm" not in k} == {
            "loss count": 1, "loss": 1, "metrics": 1, "metrics min/max": 1}


def test_ring_wire_bytes_match_jax():
    for op in ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute", "all-to-all", "broadcast"):
        for n in (1, 2, 3, 4, 8):
            for payload in (0, 4, 1000, 2138896):
                assert ring_wire_bytes(payload, op, n) == jax_ring_wire_bytes(
                    payload, op, n), (op, n, payload)


@pytest.mark.multiprocess
def test_loss_and_metrics_match_jax(ranks):
    """The ranks' global loss (the sum of their shares) and metrics against
    the JAX package's under shard_map on 2 devices, unequal valid masks."""
    preds, flow, valid = W.loss_inputs()
    mesh = jax_make_mesh(data=2, spatial=1, devices=jax.devices()[:2])

    def sharded(p, f, v):
        return (jax_sequence_loss(p, f, v, axis_name="data"),
                jax_flow_map_metrics(f, p[-1], v, axis_name="data"))

    loss, metrics = jax.jit(shard_map(
        sharded, mesh=mesh, in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P(), P()), check_rep=False))(preds, flow, valid)
    assert set(metrics) == set(ranks[0]["metrics"])
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-6)
        for k, v in metrics.items():
            np.testing.assert_allclose(r["metrics"][k], float(v), rtol=1e-6,
                                       err_msg=k)
    # the shares sum to the loss; with unequal masks the per-rank means'
    # mean (a DDP-style average) is another number
    assert ranks[0]["loss_share"] != ranks[1]["loss_share"]
    np.testing.assert_allclose(ranks[0]["loss_share"] + ranks[1]["loss_share"],
                               float(loss), rtol=1e-6)
    local = [float(jax_sequence_loss([p[2 * r:2 * r + 2] for p in preds],
                                     flow[2 * r:2 * r + 2],
                                     valid[2 * r:2 * r + 2]))
             for r in range(2)]
    assert abs(np.mean(local) - float(loss)) > 1e-3 * float(loss)


def test_loader_shards_match_jax():
    """Each shard's batches (file names) of two epochs, and
    ``fetch_dataloader``'s per-rank batch, equal the JAX loader's."""
    kw = dict(length=11, seed0=5, image_hw=(16, 24))
    port, ref = SyntheticStereo(**kw), JaxSyntheticStereo(**kw)
    for d in (port, ref):
        d.out_dtype = np.uint8
    for num_shards in (1, 3):
        for shard in range(num_shards):
            a = StereoDataLoader(port, 2, num_workers=1, shard_id=shard,
                                 num_shards=num_shards)
            b = JaxStereoDataLoader(ref, 2, num_workers=1, shard_id=shard,
                                    num_shards=num_shards)
            assert len(a) == len(b)
            for _ in range(2):
                got = [f for f, *_ in a]
                want = [f for f, *_ in b][:len(got)]
                assert got == want and len(got) == len(a), (num_shards, shard)
    cfg = load_config(ROOT / "configure" / "stereo_net_v2_synthetic_config.json")
    jcfg = jax_load_config(str(ROOT / "configure"
                               / "stereo_net_v2_synthetic_config.json"))
    for num_shards in (1, 2, 4):
        for shard in range(num_shards):
            a = fetch_dataloader(cfg, raw=True, shard_id=shard,
                                 num_shards=num_shards)
            b = jax_fetch_dataloader(jcfg, raw=True, shard_id=shard,
                                     num_shards=num_shards)
            assert (a.batch_size, len(a)) == (b.batch_size, len(b))
            assert a.batch_size * num_shards == cfg.train.batch_size
            np.testing.assert_array_equal(a._epoch_indices(3),
                                          b._epoch_indices(3))
    with pytest.raises(ValueError, match="not divisible by 3"):
        fetch_dataloader(cfg, raw=True, shard_id=0, num_shards=3)


def test_sharded_resident_index_streams_match_jax():
    """Rank r's local index stream is the JAX package's device-r segment,
    for the same global batch, over three epochs; the ranks' scene blocks
    tile the JAX process's range."""
    world, per, b_local = 8, 5, 2
    total = world * per
    packed = {"img1": np.zeros((total, 2, 2, 3), np.uint8),
              "img2": np.zeros((total, 2, 2, 3), np.uint8),
              "disp_q": np.zeros((total, 2, 2), np.uint16)}
    mesh = jax_make_mesh(data=world, spatial=1)
    ref = JaxShardedResidentScenes(packed, mesh, global_length=total)
    # one process holds all 8 devices: its "host-local" batch is global
    want = ref.index_batches(world * b_local, epoch0=2)
    ranks = []
    for r in range(world):
        lo, hi = ShardedResidentScenes.local_scene_range(total + 3, r, world)
        assert (lo, hi) == (r * per, (r + 1) * per)
        local = {k: v[lo:hi] for k, v in packed.items()}
        ranks.append(ShardedResidentScenes(
            local, device="cpu", rank=r, world=world, global_length=total
        ).index_batches(world * b_local, epoch0=2))
    assert JaxShardedResidentScenes.local_scene_range(total, mesh) == (0, total)
    steps = 3 * (per // b_local)
    for _ in range(steps):
        segments = np.split(next(want), world)
        for r in range(world):
            np.testing.assert_array_equal(next(ranks[r]), segments[r])
    with pytest.raises(ValueError, match="not divisible"):
        next(ShardedResidentScenes(
            {k: v[:per] for k, v in packed.items()}, device="cpu", rank=0,
            world=world, global_length=total).index_batches(12))


def test_ranks_rows_of_the_augmentation_are_the_global_batch():
    """Each rank augments its rows with its rows of the global table
    (``first``, ``total``): together the one-process batch, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    b, world = 4, 2
    img1 = torch.randint(0, 256, (b, 40, 56, 3), generator=gen,
                         dtype=torch.uint8)
    img2 = torch.randint(0, 256, (b, 40, 56, 3), generator=gen,
                         dtype=torch.uint8)
    flow = -torch.rand((b, 40, 56, 1), generator=gen) * 20
    augment = make_device_augment(AugmentSpec(src_hw=(40, 56),
                                              crop_size=(32, 48)))
    want = augment(7, img1, img2, flow)
    k = b // world
    parts = [augment(7, img1[r * k:(r + 1) * k], img2[r * k:(r + 1) * k],
                     flow[r * k:(r + 1) * k], first=r * k, total=b)
             for r in range(world)]
    for i, w in enumerate(want):
        torch.testing.assert_close(torch.cat([p[i] for p in parts]), w,
                                   rtol=0, atol=0)
