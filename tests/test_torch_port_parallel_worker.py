"""The port's data-parallel steps as one rank runs them, and the JAX-free
tests of ``parallel/``.

This file imports torch and the port only: run as a script it is one rank
of a gloo group (``RSM_*`` env vars, set by ``spawn_ranks``), the worker of
``tests/test_torch_port_parallel.py``, which runs the same cases in one
process on the global batch and holds the ranks to it.  The cases
(``CASES``): v1's kernel train step in float64 and float32, and the plain
step in float64 of v1 (BatchNorm2d / 3d), V4 (GroupedBatchNorm2d over the
stacked views) and MobileDispNetC, each from the train-start init of its
repo config at a small crop; then the collective audit of v1's float32
kernel step and the loss and metrics on inputs with unequal valid masks per
rank.

The tests here need no JAX: ``spawn_ranks`` fails the run at once when a
rank dies and kills ranks that outlive their time; ``initialize`` does
nothing without its env vars; the mesh and ``shard_batch``; the
differentiable all-reduce and the flat gradient sum are no-ops without a
group.
"""

from __future__ import annotations

import hashlib
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # run as a script from any directory
    sys.path.insert(0, str(ROOT))

from realtime_stereo_matcher_tpu_torch.config import load_config  # noqa: E402
from realtime_stereo_matcher_tpu_torch.models.fast_train import (  # noqa: E402
    make_fast_train_step,
    running_stats,
)
from realtime_stereo_matcher_tpu_torch.parallel import (  # noqa: E402
    distributed,
    mesh as mesh_lib,
)
from realtime_stereo_matcher_tpu_torch.parallel.comm_audit import audit  # noqa: E402
from realtime_stereo_matcher_tpu_torch.train.loss import (  # noqa: E402
    flow_map_metrics,
    sequence_loss,
)
from realtime_stereo_matcher_tpu_torch.train.trainer import (  # noqa: E402
    broadcast_state,
    create_train_state,
    make_train_step,
)

CONFIGURE = ROOT / "configure"
WORLD = 2
# case -> (repo config, step, compute dtype, global batch, crop)
CASES = {
    "kernel_f64": ("stereo_net_config.json", "kernel", torch.float64, 4,
                   (32, 64)),
    "kernel_f32": ("stereo_net_config.json", "kernel", torch.float32, 4,
                   (32, 64)),
    "plain_f64": ("stereo_net_config.json", "plain", torch.float64, 4,
                  (32, 64)),
    "v4_plain_f64": ("stereo_net_config_v4.json", "plain", torch.float64, 2,
                     (48, 64)),
    "dispnetc_plain_f64": ("disp_net_c_config.json", "plain", torch.float64,
                           4, (64, 128)),
}
# the loss / metrics inputs: 2 images a rank, valid fractions per rank
LOSS_B, LOSS_HW, LOSS_VALID = 4, (16, 24), (0.9, 0.3)


def case_batch(name: str, seed: int = 0) -> tuple:
    """The global batch of case ``name`` (numpy): a textured left image, the
    right one shifted 2 px, flow near -2, and valid masks whose density
    differs between the ranks' halves."""
    b, (h, w) = CASES[name][3], CASES[name][4]
    rng = np.random.default_rng(seed)
    img1 = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    img2 = np.roll(img1, -2, axis=2)
    flow = (-2.0 + rng.normal(0, 0.5, (b, h, w, 1))).astype(np.float32)
    frac = np.repeat([0.95, 0.6], b // 2)[:, None, None]
    valid = (rng.uniform(size=(b, h, w)) < frac).astype(np.float32)
    return img1, img2, flow, valid


def loss_inputs(seed: int = 1) -> tuple:
    """(preds, flow, valid) for the loss and metrics: three levels, the
    first at half size, one flow beyond max_flow_magnitude, and valid
    masks of density ``LOSS_VALID`` on each rank's half."""
    rng = np.random.default_rng(seed)
    b, (h, w) = LOSS_B, LOSS_HW
    flow = -rng.uniform(0, 30, (b, h, w, 1)).astype(np.float32)
    flow[0, 0, 0, 0] = -800.0
    frac = np.repeat(LOSS_VALID, b // 2)[:, None, None]
    valid = (rng.uniform(size=(b, h, w)) < frac).astype(np.float32)
    preds = [-rng.uniform(0, 30, (b, h // 2, w // 2, 1)).astype(np.float32)]
    preds += [flow + rng.normal(0, s, flow.shape).astype(np.float32)
              for s in (3.0, 0.7)]
    return preds, flow, valid


def case_state(name: str):
    """(config, train state) of case ``name``: the repo config's model at
    its train-start init (seed 1234), in the case's dtype, on the CPU."""
    cfg = load_config(CONFIGURE / CASES[name][0])
    cfg.data.image_size = list(CASES[name][4])
    cfg.train.batch_size = CASES[name][3]
    *_, state = create_train_state(cfg, device="cpu")
    if CASES[name][2] == torch.float64:
        state.model.double()
    return cfg, state


def case_step(name: str, cfg, state, group):
    """The step function of case ``name`` over ``group``."""
    _, kind, dtype, _, _ = CASES[name]
    params = cfg.train.loss.parameters
    if kind == "kernel":
        return make_fast_train_step(state.model, state.tx, params,
                                    dtype=dtype, group=group)
    return make_train_step(state.model, state.tx, params, group=group)


def param_hash(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_step(step_fn, state, batch) -> dict:
    """One step; its metrics, the gradients the optimizer was given (summed
    over the ranks, before the clip), the parameters and running stats
    after it and the parameters' hash."""
    grads = {}
    optimizer_step = state.tx.step

    def step():
        grads.update({k: p.grad.detach().clone()
                      for k, p in state.model.named_parameters()
                      if p.grad is not None})
        return optimizer_step()

    state.tx.step = step
    try:
        _, metrics = step_fn(state, *(torch.from_numpy(np.ascontiguousarray(a))
                                      for a in batch))
    finally:
        del state.tx.step
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads,
            "params": {k: p.detach().clone()
                       for k, p in state.model.named_parameters()},
            "stats": {k: v.clone()
                      for k, v in running_stats(state.model).items()},
            "hash": param_hash(state.model)}


def worker(out_dir: str) -> None:
    """One rank: every case on its rows of the global batch, the audit and
    the loss; results to ``<out_dir>/rank<r>.pt``."""
    torch.set_num_threads(1)
    if not distributed.initialize(device="cpu", timeout_s=120):
        raise RuntimeError("the worker runs as a rank (RSM_* env vars)")
    try:
        mesh = mesh_lib.make_mesh(data=WORLD)
        group, rank = mesh.group, mesh.rank

        def rows(arrays):
            return [torch.from_numpy(np.ascontiguousarray(a))
                    for a in mesh_lib.shard_batch(mesh, arrays)]

        out = {"rank": rank, "backend": torch.distributed.get_backend(group)}
        for name in CASES:
            cfg, state = case_state(name)
            if rank == 1:  # the broadcast must undo this
                with torch.no_grad():
                    next(state.model.parameters()).add_(1.0)
            broadcast_state(state, group)
            step_fn = case_step(name, cfg, state, group)
            out[name] = run_step(step_fn, state,
                                 mesh_lib.shard_batch(mesh, case_batch(name)))
        cfg, state = case_state("kernel_f32")
        step_fn = case_step("kernel_f32", cfg, state, group)
        report = audit(step_fn, state, *rows(case_batch("kernel_f32", seed=1)))
        del report["result"]
        out["audit"] = report
        out["audit_params"] = sum(p.numel() for p in state.model.parameters())
        preds, flow, valid = loss_inputs()
        preds, (flow, valid) = rows(preds), rows((flow, valid))
        out["loss_share"] = float(sequence_loss(preds, flow, valid,
                                                group=group))
        out["loss"] = float(distributed.all_reduce_(
            torch.tensor([out["loss_share"]]), group)[0])
        out["metrics"] = {k: float(v) for k, v in flow_map_metrics(
            flow, preds[-1], valid, group=group).items()}
        torch.save(out, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# JAX-free tests of parallel/
# ---------------------------------------------------------------------------


def test_spawn_ranks_fails_when_a_rank_dies():
    """A rank that exits non-zero fails the run at once, and the rank that
    would wait for it is killed, not waited for."""
    code = ("import os, sys, time\n"
            "if os.environ['RSM_PROCESS_ID'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with 3"):
        distributed.spawn_ranks(["-c", code], 2, timeout=50)
    assert time.monotonic() - t0 < 20


def test_spawn_ranks_kills_ranks_past_their_time():
    code = "import time\ntime.sleep(60)\n"
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="2 ranks not done in 1"):
        distributed.spawn_ranks(["-c", code], 2, timeout=1)
    assert time.monotonic() - t0 < 20


def test_spawn_ranks_hands_each_rank_its_env():
    code = ("import os\n"
            "env = os.environ\n"
            "print(env['RSM_PROCESS_ID'], env['RSM_NUM_PROCESSES'],"
            " env['RSM_COORDINATOR'].startswith('localhost:'))\n")
    outs = distributed.spawn_ranks(["-c", code], 3, timeout=60)
    assert [o.split() for o, _ in outs] == [[str(r), "3", "True"]
                                            for r in range(3)]


def test_initialize_without_env_is_single_process(monkeypatch):
    for var in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES,
                distributed.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "localhost:1")
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "1")
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.default_backend("cpu", 2) == "gloo"
    # ranks that share a card (or find none) go over gloo
    assert distributed.default_backend(
        "cuda", torch.cuda.device_count() + 1) == "gloo"


def test_mesh_and_shard_batch_of_one_process():
    mesh = mesh_lib.make_mesh()
    assert (mesh.group, mesh.size, mesh.rank) == (None, 1, 0)
    assert mesh_lib.make_mesh(data=1) == mesh
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(data=2)
    x = np.arange(8).reshape(4, 2)
    (got,) = mesh_lib.shard_batch(mesh, (x,))
    np.testing.assert_array_equal(got, x)
    two = [mesh_lib.shard_batch(_FakeMesh(r, 2), (x,))[0] for r in range(2)]
    np.testing.assert_array_equal(np.concatenate(two), x)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.shard_batch(_FakeMesh(0, 3), (x,))


class _FakeMesh:
    def __init__(self, rank, size):
        self.rank, self.size = rank, size


def test_collectives_without_a_group_change_nothing():
    x = torch.randn(5, requires_grad=True)
    y = distributed.all_reduce_sum(x, None)
    assert y is x
    t = torch.ones(3)
    assert distributed.all_reduce_(t, None, op="max") is t
    model = torch.nn.Linear(3, 2)
    model(torch.randn(4, 3)).sum().backward()
    before = [p.grad.clone() for p in model.parameters()]
    with distributed.CollectiveRecorder() as rec:
        distributed.sum_gradients(model.parameters(), None)
        distributed.broadcast_tensors_(list(model.parameters()), None)
    assert rec.records == []
    for p, g in zip(model.parameters(), before):
        torch.testing.assert_close(p.grad, g, rtol=0, atol=0)


@pytest.fixture
def one_torch_thread():
    """One torch thread, as a rank has: under the suite's parallel workers,
    a step spread over every core slows every worker to a crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_single_process_step_issues_no_collective(one_torch_thread):
    """Without a group the kernel step, the one the ranks are held to,
    issues no collective and moves the parameters."""
    cfg, state = case_state("kernel_f32")
    before = param_hash(state.model)
    step_fn = case_step("kernel_f32", cfg, state, None)
    report = audit(run_step, step_fn, state, case_batch("kernel_f32"))
    assert report["inventory"] == []
    assert report["result"]["hash"] != before
    assert all(np.isfinite(v) for v in report["result"]["metrics"].values())


if __name__ == "__main__":
    worker(sys.argv[1])
