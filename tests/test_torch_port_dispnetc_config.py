"""``train_stereo`` / ``train()`` on the committed synthetic configs of
MobileDispNetC and MobileStereoNetV4, on the CPU, with no ``data_loader=``.

* DispNetC: ``configure/disp_net_c_synthetic_config.json`` through the
  ``train_stereo`` entry point at its full width and train section (batch
  8, 256 x 320 crops of 320 x 448 scenes, ``device_augment``), its one cut
  the dataset (``synthetic_8``, one batch an epoch), for 2 steps;
* V4: ``configure/stereo_net_v4_synthetic_config.json`` through ``train()``
  at its full width, cut to ``synthetic_8``, batch 2 and 96 x 128 crops (a
  V4 step at its batch 6, 240 x 320 takes minutes on this CPU; the card
  runs the section as committed, ``chip_smoke.py`` phase "v4"), in float32:
  under bf16 autocast on this CPU, oneDNN's weight gradient of a dilated
  depthwise conv of V4's extractor (``layer4.2.conv2.0``) now and then
  comes out non-finite (1 of 4 identical steps at batch 6, 240 x 320), so
  a bf16 run here can turn NaN; the card's bf16 runs of the config stay
  finite.

Each takes the plain step (neither model has a kernel path, as in the JAX
package) on the resident path (scenes packed on the device, index batches
augmented there), writes the JAX package's metric-log rows (one a step:
live loss and learning rate) and finite losses; ``fast_kernels: "on"``
raises for both, as in the JAX package.
"""

import json
import logging
import math
import pathlib

import pytest
import torch

from realtime_stereo_matcher_tpu_torch import train_stereo
from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.train.trainer import train
from test_torch_port_train_config import (  # noqa: F401 (fixtures)
    _rows,
    no_tensorboard,
    one_thread,
    scene_cache,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = {"MobileDispNetC": "disp_net_c_synthetic_config.json",
           "MobileStereoNetV4": "stereo_net_v4_synthetic_config.json"}


def _check_run(cfg, caplog, losses, batches, shape):
    assert "Training on the plain path." in caplog.text
    assert "Device-resident dataset: 8 scenes" in caplog.text
    assert sorted(losses) == [0, 1]
    assert all(math.isfinite(v) for v in losses.values())
    img1, _, flow, valid = batches[0]
    assert img1.shape == shape + (3,) and flow.shape == shape + (1,)
    rows = _rows(cfg)
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert set(r) == {"step", "time", "live_loss", "learning_rate"}
        assert r["live_loss"] == pytest.approx(losses[r["step"]], rel=1e-6)


def test_dispnetc_config_through_the_entry_point(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    raw = json.loads((ROOT / "configure" / CONFIGS["MobileDispNetC"])
                     .read_text())
    assert raw["train"]["device_augment"] and (
        raw["train"]["batch_size"], raw["data"]["image_size"]) == (8,
                                                                  [256, 320])
    raw["path"] = str(tmp_path / "exp")
    raw["train"]["datasets"] = ["synthetic_8"]
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    losses, batches = {}, {}
    final = train_stereo.main(
        [f"--exp_config_json={path}", "--max_steps=1", "--device=cpu"],
        on_step=lambda s, m: losses.__setitem__(s, float(m["live_loss"])),
        on_batch=lambda s, b: batches.__setitem__(s, b))
    assert torch.load(final, weights_only=True)["step"] == 2
    _check_run(load_config(path), caplog, losses, batches, (8, 256, 320))


def test_v4_config_trains_on_the_resident_path(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    cfg = load_config(ROOT / "configure" / CONFIGS["MobileStereoNetV4"])
    assert cfg.train.device_augment and (
        cfg.train.batch_size, cfg.data.image_size) == (6, [240, 320])
    cfg.path = str(tmp_path / "exp")
    cfg.train.datasets = ["synthetic_8"]
    cfg.train.batch_size = 2
    cfg.data.image_size = [96, 128]
    losses, batches = {}, {}
    final = train(cfg, max_steps=1, device="cpu", use_bf16=False,
                  on_step=lambda s, m: losses.__setitem__(
                      s, float(m["live_loss"])),
                  on_batch=lambda s, b: batches.__setitem__(s, b))
    assert torch.load(final, weights_only=True)["step"] == 2
    _check_run(cfg, caplog, losses, batches, (2, 96, 128))


@pytest.mark.parametrize("mtype", sorted(CONFIGS))
def test_fast_kernels_on_raises(mtype, tmp_path):
    cfg = load_config(ROOT / "configure" / CONFIGS[mtype])
    cfg.path = str(tmp_path / "exp")
    cfg.train.fast_kernels = "on"
    with pytest.raises(ValueError, match="fast_kernels='on'"):
        train(cfg, max_steps=1, device="cpu", data_loader=[])
