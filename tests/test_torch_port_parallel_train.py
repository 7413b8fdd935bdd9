"""The port's data-parallel entry points across processes, on the CPU.

* ``train_stereo`` as two gloo ranks (``RSM_*`` env vars, one process per
  rank, as a user launches it) on a copy of
  ``configure/stereo_net_v2_synthetic_config.json`` cut to 8 scenes, a
  64 x 96 crop and a global batch of 4, for ``--max_steps 1`` (2 steps):
  both ranks exit 0, each packs its 4 resident scenes and takes 2 of the
  global 4 a step on the kernel path, their final parameters hash equal,
  and only rank 0 writes the checkpoint and ``scalars.jsonl`` (one row a
  step).
* ``scaling_bench.scaling_efficiency`` at 1 rank (here) and 2 (spawned
  ranks of the module) on v1 at 32 x 64, one frame a rank.
"""

import json
import pathlib

import pytest
import torch

from realtime_stereo_matcher_tpu_torch.parallel.distributed import spawn_ranks
from realtime_stereo_matcher_tpu_torch.parallel.scaling_bench import (
    scaling_efficiency,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = ROOT / "configure" / "stereo_net_v2_synthetic_config.json"

# one rank of train_stereo; prints the final parameters' hash
_RANK = r"""
import hashlib, json, sys
import torch
torch.set_num_threads(1)
sys.modules["torch.utils.tensorboard"] = None  # its import takes ~20 s here
from realtime_stereo_matcher_tpu_torch import train_stereo
from realtime_stereo_matcher_tpu_torch.train import trainer

states = []
create = trainer.create_train_state

def capture(*args, **kwargs):
    out = create(*args, **kwargs)
    states.append(out[-1])
    return out

trainer.create_train_state = capture
steps = []
ckpt = train_stereo.main(
    ["--exp_config_json", sys.argv[1], "--max_steps", "1", "--device", "cpu"],
    on_step=lambda step, m: steps.append(float(m["live_loss"])))
h = hashlib.sha256()
for p in states[0].model.parameters():
    h.update(p.detach().contiguous().numpy().tobytes())
print(json.dumps({"hash": h.hexdigest(), "ckpt": ckpt,
                  "step": states[0].step, "losses": steps}))
"""


@pytest.mark.multiprocess
def test_train_stereo_on_two_ranks(tmp_path):
    cfg = json.loads(CONFIG.read_text())
    cfg["path"] = str(tmp_path / "run")
    cfg["train"]["datasets"] = ["synthetic_8"]
    cfg["train"]["batch_size"] = 4
    cfg["data"]["image_size"] = [64, 96]
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    outs = spawn_ranks(["-c", _RANK, path], 2, timeout=240, cwd=ROOT)
    results = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert results[0]["hash"] == results[1]["hash"]
    assert [r["step"] for r in results] == [2, 2]
    # the metrics are the global batch's on both ranks
    assert results[0]["losses"] == results[1]["losses"]
    assert len(results[0]["losses"]) == 2
    ckpts = list((tmp_path / "run" / "checkpoints").iterdir())
    assert [c.name for c in ckpts] == [pathlib.Path(results[0]["ckpt"]).name]
    rows = (tmp_path / "run" / "runs" / "scalars.jsonl").read_text()
    assert [json.loads(r)["step"] for r in rows.splitlines()] == [0, 1]
    errs = [err for _, err in outs]
    assert "Saving file" in errs[0] and "Saving file" not in errs[1]
    for rank, err in enumerate(errs):
        assert f"rank {rank} of 2 (data-parallel, 2 of a global batch of 4)" \
            in err
        assert "Training on the kernel path" in err
        assert "Device-resident dataset: 4 scenes" in err


@pytest.mark.multiprocess
def test_scaling_efficiency_on_one_and_two_ranks(monkeypatch):
    # one torch thread a rank, here and in the spawned ranks: the suite's
    # parallel workers share the cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        results = scaling_efficiency([1, 2], image_hw=(32, 64),
                                     frames_per_device=1, iters=2,
                                     device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert set(results) == {1, 2}
    for r in results.values():
        assert r["fps"] > 0
    assert abs(results[1]["efficiency"] - 1.0) < 1e-12
