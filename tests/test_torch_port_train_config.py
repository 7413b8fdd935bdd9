"""``train()`` and the ``train_stereo`` entry point of the port on every
committed synthetic training config, on the CPU, with no ``data_loader=``.

Each config keeps its data and train sections (batch 8, 240 x 320 crops of
320 x 448 synthetic scenes, ``device_augment: true``); only the dataset
length (``synthetic_8``: one batch an epoch) and the model's widths (hidden
8, two refine dilations) are cut, so every run takes the plain step here.

* the resident path: the scenes packed on the device, index batches
  augmented there, the metric log's rows as the JAX package's logger writes
  them (one per step: live loss and learning rate);
* resume at an epoch boundary: the checkpoint of step 1 restored gives
  step 1's augmented batch bit for bit and its loss within 1e-6 relative
  (the same weights, the same CPU arithmetic);
* the streaming path (the JAX package's rule: the pack refused, raw uint8
  batches from the host loader, augmented on the device) through
  ``python -m realtime_stereo_matcher_tpu_torch.train_stereo --device cpu``;
* ``train.freeze_bn``: the plain step with every BatchNorm frozen, also
  when ``fast_kernels`` is "on" (with the JAX package's warning), running
  stats unchanged.

TensorBoard is made unimportable in these runs, so the logger writes only
its JSONL file (``torch.utils.tensorboard`` imports TensorFlow here, ~20 s);
torch runs on one thread (about a minute for the file).
"""

import json
import logging
import math
import pathlib
import sys

import pytest
import torch

from realtime_stereo_matcher_tpu_torch import train_stereo
from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.data.synthetic import SyntheticBatches
from realtime_stereo_matcher_tpu_torch.train import trainer
from realtime_stereo_matcher_tpu_torch.train.trainer import train

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ("stereo_net_synthetic_config.json",
           "stereo_net_v2_synthetic_config.json",
           "stereo_net_v3_synthetic_config.json")


@pytest.fixture(autouse=True, scope="module")
def scene_cache(tmp_path_factory):
    """The resident packs cached in a directory of this module's run (one
    pack of ``synthetic_8`` for every test here), not the checkout's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "SCENE_CACHE_DIR",
                   tmp_path_factory.mktemp("scene_cache"))
        yield


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the runs here are memory-bound elementwise work at
    the configs' full scene size, which slows to a crawl when the workers
    of a parallel test run each spread it over every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cut(name, path, scenes=8):
    cfg = load_config(ROOT / "configure" / name)
    assert cfg.train.device_augment and cfg.train.datasets == ["synthetic_4000"]
    assert (cfg.train.batch_size, cfg.data.image_size) == (8, [240, 320])
    cfg.path = str(path)
    cfg.train.datasets = [f"synthetic_{scenes}"]
    cfg.model.parameters = dict(cfg.model.parameters, hidden_dim=8,
                                refine_dilates=[1, 2])
    return cfg


def _rows(cfg):
    lines = (pathlib.Path(cfg.path) / "runs" / "scalars.jsonl").read_text()
    return [json.loads(line) for line in lines.splitlines()]


@pytest.mark.parametrize("name", CONFIGS)
def test_resident_run_and_resume_at_an_epoch_boundary(name, tmp_path, caplog):
    caplog.set_level(logging.INFO)
    cfg = _cut(name, tmp_path / "a")
    cfg.train.save_checkpoint_frequency = 1
    seen, got_loss = {}, {}
    final = train(cfg, max_steps=1, device="cpu",
                  on_batch=lambda s, b: seen.__setitem__(s, [t.clone()
                                                             for t in b]),
                  on_step=lambda s, m: got_loss.__setitem__(
                      s, float(m["live_loss"])))
    assert "Device-resident dataset: 8 scenes" in caplog.text
    assert "steps ship indices" in caplog.text
    assert pathlib.Path(final).name.endswith("-epoch-2.ckpt")
    assert sorted(seen) == [0, 1]
    img1, img2, flow, valid = seen[0]
    assert img1.shape == img2.shape == (8, 240, 320, 3)
    assert flow.shape == (8, 240, 320, 1) and valid.shape == (8, 240, 320)
    assert img1.dtype == flow.dtype == torch.float32
    assert 0 <= float(img1.min()) and float(img1.max()) <= 255
    assert all(math.isfinite(v) for v in got_loss.values())
    # the JAX package's rows: one a step, its live loss and learning rate
    rows = _rows(cfg)
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert set(r) == {"step", "time", "live_loss", "learning_rate"}
        assert r["live_loss"] == pytest.approx(got_loss[r["step"]], rel=1e-6)

    # step 1 starts epoch 1: its checkpoint, restored, gives step 1 again
    ckpt = pathlib.Path(cfg.path) / "checkpoints" / (
        f"{cfg.name}-epoch-1.ckpt")
    resumed = _cut(name, tmp_path / "b")
    resumed.train.restore_checkpoint = str(ckpt)
    again, again_loss = {}, {}
    train(resumed, max_steps=1, device="cpu",
          on_batch=lambda s, b: again.__setitem__(s, b),
          on_step=lambda s, m: again_loss.__setitem__(s, float(
              m["live_loss"])))
    assert sorted(again) == [1]
    for a, b in zip(again[1], seen[1]):
        assert torch.equal(a, b)
    assert again_loss[1] == pytest.approx(got_loss[1], rel=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_entry_point_streams_when_the_pack_is_refused(name, tmp_path,
                                                      monkeypatch, caplog):
    caplog.set_level(logging.INFO)
    monkeypatch.setattr(trainer, "MAX_RESIDENT_BYTES", 0)
    cfg = _cut(name, tmp_path / "exp")
    raw = json.loads((ROOT / "configure" / name).read_text())
    raw["path"] = cfg.path
    raw["train"]["datasets"] = cfg.train.datasets
    raw["model"]["parameters"] = cfg.model.parameters
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    final = train_stereo.main([f"--exp_config_json={path}", "--max_steps=1",
                               "--device=cpu"])
    assert "Device-resident dataset refused" in caplog.text
    assert "Streaming raw batches from the host" in caplog.text
    assert "On-device augmentation: raw (320, 448) -> crop (240, 320)" in (
        caplog.text)
    assert torch.load(final, weights_only=True)["step"] == 2
    assert [r["step"] for r in _rows(cfg)] == [0, 1]


def test_entry_point_runs_on_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_stereo.main([f"--exp_config_json={ROOT / 'configure' / CONFIGS[1]}",
                           "--max_steps=1"])
    args = train_stereo.parse_args(["--no-bf16"])
    assert (args.bf16, args.device, args.max_steps) == (False, "cuda", None)


@pytest.mark.parametrize("fast", ["on", "auto"])
def test_freeze_bn_trains_with_frozen_running_stats(fast, tmp_path, caplog):
    cfg = load_config(ROOT / "configure" / "stereo_net_config.json")
    cfg.path = str(tmp_path / "exp")
    cfg.data.image_size = [32, 64]
    cfg.train.batch_size = 2
    cfg.train.freeze_bn = True
    cfg.train.fast_kernels = fast
    data = SyntheticBatches(2, (32, 64), n_batches=1, max_disp=16.0)
    model, *_ = trainer.create_train_state(cfg, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k.endswith(("running_mean", "running_var"))}
    assert before
    with caplog.at_level(logging.INFO):
        final = train(cfg, max_steps=1, data_loader=data, device="cpu",
                      use_bf16=False)
    assert "Training on the plain path." in caplog.text
    assert ("overridden to 'off' by train.freeze_bn" in caplog.text) == (
        fast == "on")
    after = torch.load(final, weights_only=True)["model"]
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    # the weights did train
    assert any(not torch.equal(after[k], v)
               for k, v in model.state_dict().items() if k.endswith("weight"))
