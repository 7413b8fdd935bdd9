"""The port's validators, ``ModelRunner`` and entry points against the JAX
package, on the CPU, with a small seeded v2 (hidden 8, dilations (1, 1)):

* the five validators on temporary trees laid out as in
  tests/test_dataset_families.py and tests/test_eval.py, and
  ``run_validation`` under one data root: the port's
  ``ModelRunner(device="cpu")`` against the JAX package's
  ``ModelRunner(fast=False)``, every metric except FPS within 1e-4;
* ``ModelRunner``'s options: ``fast="auto"`` on the CPU is the plain
  float32 model, ``fast=True`` the kernel path's plain versions, both
  exactly; without ``device`` it raises where CUDA is absent; the latency
  is measured once per padded shape;
* the entry points with ``--device cpu``: ``evaluate`` prints the JAX
  package's metrics (within 1e-4), exits on a trainable config without a
  checkpoint, raises ``NotImplementedError`` for SGBM and raises without
  CUDA when no ``--device`` is given; ``infer`` writes the PFM that the
  root ``test_stereo.py`` writes on the same PNG pair (through
  ``sys.argv``), within 2e-4 px, the plain model's bound against Flax in
  tests/test_torch_port_v2_model.py.

One port runner and one JAX runner serve every validator test, so that
each padded shape is compiled (JAX) and timed (port) once.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.eval import validators as jax_validators
from realtime_stereo_matcher_tpu_torch import evaluate, infer
from realtime_stereo_matcher_tpu_torch.data.synthetic import make_scene
from realtime_stereo_matcher_tpu_torch.eval import validators
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.utils import pfm
from test_dataset_families import (
    _disp_pfm,
    _png,
    make_eth3d,
    make_middlebury_2014,
    make_middlebury_eval3,
)
from test_eval import _make_kitti
from test_torch_port_eval import (
    ROOT,
    SMALL_V2,
    TRAINED,
    JaxRunner,
    jax_load_config,
    jax_pfm,
)


# ---------------------------------------------------------------------------
# the validators: a small seeded v2, port against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_v2():
    """(JAX model, its variables, the port model with them), BatchNorm
    statistics drawn from a seed so that they are not the identity."""
    from realtime_stereo_matcher_tpu.models import build_model as jax_build

    model = jax_build(SMALL_V2)
    dummy = np.zeros((1, 64, 64, 3), np.float32)
    variables = jax.jit(lambda key: model.init(key, dummy, dummy,
                                               train=False))(
        jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(7)

    def randomize(path, x):
        name = str(path[-1])
        if "mean" in name:
            return rng.normal(0, 0.2, x.shape).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    variables = {"params": variables["params"],
                 "batch_stats": jax.tree_util.tree_map_with_path(
                     randomize, variables["batch_stats"])}
    port = build_model(SMALL_V2, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    return model, variables, port


@pytest.fixture(scope="module")
def runners(small_v2):
    """(port runner, JAX runner) of the small v2, shared by the validator
    tests: each caches its work per padded shape."""
    model, variables, port = small_v2
    return (validators.ModelRunner(port, device="cpu"),
            JaxRunner(model, variables, fast=False))


def _same_metrics(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if not k.endswith("-fps"):
            assert abs(got[k] - w) <= 1e-4, (k, got[k], w)
    assert all(v > 0 for k, v in got.items() if k.endswith("-fps"))


def _things_tree(root, rng):
    """Two FlyingThings TEST scenes of the finalpass, half of each past the
    |gt| < 192 mask (tests/test_dataset_families.py)."""
    for i in range(2):
        rel = f"FlyingThings3D/frames_finalpass/TEST/A/{i:04d}/left/0006.png"
        _png(root / rel, rng)
        _png(root / rel.replace("left", "right"), rng)
        d = rng.uniform(1, 30, (96, 128)).astype(np.float32)
        d[:, 100:] = 300.0
        _disp_pfm(root / rel.replace("frames_finalpass", "disparity").replace(
            ".png", ".pfm"), d)


@pytest.mark.parametrize("name", ["eth3d", "kitti", "things",
                                  "middlebury_2014", "middlebury_F",
                                  "synthetic"])
def test_validators_match_jax(tmp_path, rng, runners, name):
    runner, jax_runner = runners
    root = str(tmp_path)
    if name == "eth3d":
        make_eth3d(tmp_path, rng, disps=(17.0, 150.0))
        args = ("validate_eth3d", dict(root=root))
    elif name == "kitti":
        _make_kitti(tmp_path, rng, n=2)
        args = ("validate_kitti", dict(root=root + "/KITTI"))
    elif name == "things":
        _things_tree(tmp_path, rng)
        args = ("validate_things", dict(root=root))
    elif name.startswith("middlebury"):
        split = name.split("_")[1]
        (make_middlebury_2014 if split == "2014" else make_middlebury_eval3)(
            tmp_path, rng)
        args = ("validate_middlebury", dict(root=root, split=split))
    else:
        args = ("validate_synthetic", dict(n_images=3, image_hw=(96, 128),
                                           max_disp=24.0))
    fn, kw = args
    _same_metrics(getattr(validators, fn)(runner, **kw),
                  getattr(jax_validators, fn)(jax_runner, **kw))


def test_run_validation_matches_jax(tmp_path, rng, runners):
    """The config's dataset names dispatched under one data root."""
    runner, jax_runner = runners
    make_eth3d(tmp_path / "ETH3D", rng)
    _make_kitti(tmp_path, rng, n=1)
    make_middlebury_eval3(tmp_path / "Middlebury", rng, split="Q")
    _things_tree(tmp_path / "SceneFlow", rng)
    names = ["eth3d", "kitti", "middlebury_Q", "things"]
    got = validators.run_validation(runner, names, data_root=str(tmp_path))
    want = jax_validators.run_validation(jax_runner, names,
                                         data_root=str(tmp_path))
    _same_metrics(got, want)
    with pytest.raises(ValueError, match="unknown test dataset"):
        validators.run_validation(runner, ["nope"])


# ---------------------------------------------------------------------------
# ModelRunner and the entry points
# ---------------------------------------------------------------------------


def test_model_runner_paths_on_the_cpu(small_v2):
    from realtime_stereo_matcher_tpu_torch.models.fast_infer import (
        make_fast_forward,
    )

    _, _, port = small_v2
    left, right = (torch.rand(1, 64, 128, 3, generator=torch.Generator(
        ).manual_seed(i)) * 255 for i in range(2))
    auto = validators.ModelRunner(port, device="cpu")
    assert not auto.fast and auto.dtype == torch.float32
    with torch.no_grad():
        want = port(left, right)
    for g, w in zip(auto(left, right), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    fast = validators.ModelRunner(port, fast=True, dtype=torch.float32,
                                  device="cpu")
    assert fast.fast
    want = make_fast_forward(port, dtype=torch.float32)(left, right)
    for g, w in zip(fast(left, right), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="fast must be"):
        validators.ModelRunner(port, fast="on", device="cpu")


@pytest.mark.parametrize("mtype", ["MobileStereoNetV4", "MobileDispNetC"])
def test_model_runner_takes_models_without_a_kernel_path(mtype):
    """V4 and DispNetC have no kernel path (nor have they in the JAX
    package): ``fast="auto"`` runs their plain forward (float32 on the CPU;
    on CUDA autocast to ``dtype``), ``fast=True`` raises, ``fast=False`` is
    the plain float32 model."""
    model = build_model({"type": mtype, "parameters": {}}, device="cpu")
    left, right = (torch.rand(1, 64, 64, 3, generator=torch.Generator(
        ).manual_seed(i)) * 255 for i in range(2))
    with torch.no_grad():
        want = model(left, right)
    for fast in ("auto", False):
        runner = validators.ModelRunner(model, fast=fast, device="cpu")
        assert not runner.fast and runner.dtype == torch.float32
        for g, w in zip(runner(left, right), want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="no kernel path"):
        validators.ModelRunner(model, fast=True, device="cpu")


def test_model_runner_needs_cuda_by_default(small_v2):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validators.ModelRunner(small_v2[2])


def test_latency_is_measured_once_per_shape(monkeypatch, small_v2):
    runner = validators.ModelRunner(small_v2[2], device="cpu")
    calls = []
    forward = runner._forward
    monkeypatch.setattr(runner, "_forward",
                        lambda a, b: calls.append(a.shape) or forward(a, b))
    a, b = torch.zeros(1, 64, 64, 3), torch.zeros(1, 64, 128, 3)
    first = runner.latency(a, a)
    assert runner.latency(a, a) == first > 0
    runner.latency(b, b)
    n = validators.LATENCY_WARMUP + validators.LATENCY_ITERS
    assert calls == [a.shape] * n + [b.shape] * n


def test_evaluate_refuses_what_it_cannot_run():
    v2 = TRAINED["v2"]
    with pytest.raises(SystemExit, match="--model_chkpt_file is required"):
        evaluate.main([f"--exp_config_json={ROOT / v2['config']}",
                       "--device=cpu"])
    with pytest.raises(NotImplementedError, match="OpenCVSGBMModule"):
        evaluate.main([f"--exp_config_json="
                       f"{ROOT / 'configure/opencv_sgbm_config.json'}"])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main([f"--exp_config_json={ROOT / v2['config']}",
                       f"--model_chkpt_file={ROOT / v2['weights']}"])


def _small_experiment(tmp_path, small_v2, test_sets, orbax=False):
    """A config of the small v2 (float32, a train section), its weights as
    the port's file and, with ``orbax``, as the JAX package's checkpoint."""
    from realtime_stereo_matcher_tpu.train.optim import make_optimizer
    from realtime_stereo_matcher_tpu.train.trainer import (
        TrainState,
        save_checkpoint,
    )

    _, variables, port = small_v2
    raw = {"name": "SMALL_V2", "path": str(tmp_path / "exp"),
           "model": dict(SMALL_V2, mixed_precision=False),
           "train": {"batch_size": 1, "num_of_steps": 10},
           "data": {"image_size": [32, 32]}, "test": {"datasets": test_sets}}
    config = tmp_path / "small_v2.json"
    config.write_text(json.dumps(raw))
    weights = tmp_path / "small_v2.pt"
    torch.save(port.state_dict(), weights)
    if not orbax:
        return config, weights, None
    # the full train state test_stereo.py's create_train_state restores
    tcfg = jax_load_config(raw).train
    tx, _ = make_optimizer(tcfg.learn_rate, tcfg.num_of_steps,
                           tcfg.weight_decay)
    orbax = tmp_path / "small_v2.ckpt"
    save_checkpoint(orbax, TrainState(
        step=np.zeros((), np.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"])))
    return config, weights, orbax


def test_evaluate_on_the_cpu_matches_jax(tmp_path, rng, small_v2, runners,
                                        capsys):
    config, weights, _ = _small_experiment(tmp_path, small_v2, ["kitti"])
    _make_kitti(tmp_path, rng, n=2)
    got = evaluate.main([f"--exp_config_json={config}",
                         f"--model_chkpt_file={weights}", "--device=cpu",
                         f"--data_root={tmp_path}"])
    assert "Validation KITTI: EPE" in capsys.readouterr().out
    want = jax_validators.run_validation(runners[1], ["kitti"],
                                         data_root=str(tmp_path))
    _same_metrics(got, want)


def test_infer_writes_the_pfm_of_test_stereo(tmp_path, small_v2, monkeypatch):
    """The root test_stereo.py (the JAX package, through sys.argv) and the
    port's infer on the same PNG pair write the same disparity within 2e-4
    px, and the same files."""
    import importlib.util

    from PIL import Image

    config, weights, orbax = _small_experiment(tmp_path, small_v2, [],
                                               orbax=True)
    left, right, _, _ = make_scene(3, 100, 150, max_disp=24.0)
    images = tmp_path / "images"
    images.mkdir()
    Image.fromarray(left).save(images / "a_left.png")
    Image.fromarray(right).save(images / "a_right.png")
    spec = importlib.util.spec_from_file_location("test_stereo",
                                                  ROOT / "test_stereo.py")
    test_stereo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(test_stereo)
    common = [f"--exp_config_json={config}", f"--left={images}/*_left.png",
              "--replace", "_left", "_right"]
    monkeypatch.setattr(sys, "argv", ["test_stereo.py", *common,
                                      f"--model_chkpt_file={orbax}",
                                      f"--output={tmp_path / 'jax'}"])
    test_stereo.main()
    written = infer.main([*common, f"--model_chkpt_file={weights}",
                          f"--output={tmp_path / 'port'}", "--device=cpu"])
    name = "SMALL_V2/a_150x100_disparity"
    assert written == [str(tmp_path / "port" / f"{name}.pfm")]
    got, scale = pfm.read_pfm(tmp_path / "port" / f"{name}.pfm")
    want, want_scale = jax_pfm.read_pfm(tmp_path / "jax" / f"{name}.pfm")
    assert scale == want_scale == 1.0 and got.shape == want.shape == (100, 150)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    png = np.asarray(Image.open(tmp_path / "port" / f"{name}.png"))
    assert png.shape == (100, 150, 3) and png.dtype == np.uint8
    assert (tmp_path / "jax" / f"{name}.png").exists()


