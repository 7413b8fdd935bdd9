"""The program a cell runs is the route the port itself takes: frames
through ``eval/validators.ModelRunner`` (the kernel path of v1-v3, the
plain forward of V4 and DispNetC), training steps as the port's trainer
chooses them."""

import time
import types

import pytest
import torch

from stereobench import run, scenes
from stereobench.loops import camera, train

SMALL = {
    "MobileStereoNetV4": {"max_disp": 32, "volume_size": 8, "hg_size": 8},
    "MobileDispNetC": {"max_disp": 32},
}


def _cell(model_config, device="cpu"):
    """What ``port_program`` reads of a cell."""
    return types.SimpleNamespace(config={"model": model_config,
                                         "dtype": "bfloat16"},
                                 device=torch.device(device))


def _pair(b, h, w, device="cpu"):
    gen = torch.Generator().manual_seed(3)
    return [torch.randint(0, 256, (b, h, w, 3), generator=gen,
                          dtype=torch.uint8).to(device) for _ in range(2)]


def _port_model(model_config, device="cpu"):
    from realtime_stereo_matcher_tpu_torch.models import build_model
    return build_model(model_config, device=device,
                       generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("model_type", sorted(SMALL))
def test_a_model_without_a_kernel_path_runs_its_plain_forward(model_type):
    torch.set_num_threads(2)
    cfg = {"type": model_type, "parameters": SMALL[model_type]}
    net = _port_model(cfg)
    forward = camera.port_program(_cell(cfg), net.state_dict())
    left, right = _pair(2, 64, 96)
    got = forward(left, right)
    with torch.no_grad():
        want = net(left, right)
    assert forward.fast is False and forward.dtype == torch.float32
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.shape == (2, 64, 96, 1)
        assert torch.equal(g, w)


@pytest.mark.parametrize("config", ["mobilestereonet-v2", "mobilestereonet-v3"])
def test_v2_and_v3_run_the_kernel_path(config):
    from realtime_stereo_matcher_tpu_torch.models.fast_infer import (
        GraphPolicy,
        make_fast_forward,
    )
    torch.set_num_threads(2)
    cfg = run._json(run.ROOT / "stereobench" / "configs" / f"{config}.json")
    net = _port_model(cfg["model"])
    forward = camera.port_program(_cell(cfg["model"]), net.state_dict())
    assert forward.fast is True and forward.dtype == torch.bfloat16
    assert isinstance(forward._forward, GraphPolicy)
    left, right = _pair(2, 32, 64)
    want = make_fast_forward(net, dtype=torch.bfloat16)(left, right)
    got = forward(left, right)
    assert len(got) == len(want) == 3
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_the_configurations_dtype_is_read_not_assumed():
    assert camera.config_dtype({"dtype": "float32"}) == torch.float32
    assert camera.config_dtype({"dtype": "bfloat16"}) == torch.bfloat16
    for bad in ({}, {"dtype": "int8"}, {"dtype": "bf16"}):
        with pytest.raises(ValueError, match="'dtype'"):
            camera.config_dtype(bad)


def _train_cell(model_config=None):
    cell, _ = run.load_cell("v2-train-b32", seed=2**31 + 41, seconds=0.3,
                            trace=False, device="cpu", t0=time.perf_counter())
    cell.traffic.update(batch_size=2, scenes=4, scene_hw=[40, 56],
                        max_disp_px=12)
    cell.traffic["data"] = dict(cell.traffic["data"], image_size=[32, 48])
    if model_config is not None:
        cell.config = dict(cell.config, model=model_config)
    return cell


@pytest.mark.parametrize("model_type, step_module", [
    (None, "realtime_stereo_matcher_tpu_torch.models.fast_train"),
    ("MobileStereoNetV4", "realtime_stereo_matcher_tpu_torch.train.trainer"),
])
def test_the_training_step_is_the_trainers_choice(model_type, step_module):
    """v2: the kernel-path step (``fast_step_supported`` holds); V4: the
    plain step, which runs."""
    torch.set_num_threads(2)
    cfg = (None if model_type is None
           else {"type": model_type, "parameters": SMALL[model_type]})
    cell = _train_cell(cfg)
    net = _port_model(cell.config["model"])
    t = cell.traffic
    data = scenes.make_scenes(t["scenes"], *t["scene_hw"],
                              max_disp=t["max_disp_px"], seed=5, device="cpu")
    trainer = train.port_program(cell, net.state_dict(), data)
    assert trainer.step_fn.__module__ == step_module
    _, loss = trainer.step(0, torch.tensor([0, 1]))
    assert bool(torch.isfinite(loss))


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["MobileStereoNetV2", *sorted(SMALL)])
def test_on_the_card_v2_replays_and_the_others_autocast(model_type):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = {"type": model_type, "parameters": SMALL.get(model_type, {})}
    net = _port_model(cfg, "cuda")
    forward = camera.port_program(_cell(cfg, "cuda"), net.state_dict())
    assert forward.dtype == torch.bfloat16
    assert forward.fast is (model_type == "MobileStereoNetV2")
    outs = forward(*_pair(1, 64, 96, "cuda"))
    assert all(bool(torch.isfinite(o).all()) for o in outs)
