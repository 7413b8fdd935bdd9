"""The port's evaluation slice against the JAX package, on the CPU.

Each test feeds the same inputs, made from a seed with numpy, to the JAX
package's function and to its counterpart in the port:

* ``utils/pfm.py``, ``utils/colorize.py`` and ``data/frame_io.py`` (PFM,
  ``.flo``, KITTI 16-bit PNG, Sintel, FallingThings, TartanAir and
  Middlebury decoding): the same arrays, exactly;
* ``data/datasets.py``: every dataset class, unaugmented as evaluation
  builds it, on temporary trees laid out as tests/test_dataset_families.py
  and tests/test_eval.py lay them out, the same samples, exactly; with
  training ``aug_params`` (a crop: the host augmentors; a pad) and the same
  per-sample rng, the same samples, exactly;
* ``SyntheticStereo``, sample for sample: names, flow and validity exact,
  images within one level (the port's numpy scenes against cv2's); with
  the host augmentor on the same scenes, the same samples, exactly;
* ``models/checkpoint.py`` on each file format, ``utils/timing.py``, and
  ``models.is_neural`` on every repo config.

The validators, ``ModelRunner`` and the entry points are held to the JAX
package in tests/test_torch_port_eval_runs.py, the trained weights in
tests/test_torch_port_eval_v2.py, _v3.py, _v4.py and _dispnetc.py; they
share this file's helpers.  Run as a script, this file writes the port's
copies of the trained checkpoints and their held-out metrics:

    python tests/test_torch_port_eval.py --write-weights [v2 v3 v4 dispnetc]

(all four without names).  It restores each orbax checkpoint under
``experiments/`` read-only with the JAX package's ``restore_checkpoint``
into a template of its ``create_train_state``'s shapes, maps it with
``models/convert.py`` ``from_jax_variables``, saves the state dict to
``realtime_stereo_matcher_tpu_torch/weights/``, and runs the JAX package's
``validate_synthetic`` (40 held-out scenes, Flax, float32) into
``weights/held_out.json``, keeping the entries of the models not named.
"""

import json
import pathlib
import sys

if __name__ == "__main__":  # run as a script: the repo root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from realtime_stereo_matcher_tpu.config import (  # noqa: E402
    load_config as jax_load_config,
)
from realtime_stereo_matcher_tpu.data import datasets as jax_datasets  # noqa: E402
from realtime_stereo_matcher_tpu.data import frame_io as jax_frame_io  # noqa: E402
from realtime_stereo_matcher_tpu.data.synthetic import (  # noqa: E402
    SyntheticStereo as JaxSyntheticStereo,
    make_scene as jax_make_scene,
)
from realtime_stereo_matcher_tpu.eval import (  # noqa: E402
    validators as jax_validators,
)
from realtime_stereo_matcher_tpu.models import (  # noqa: E402
    build_model as jax_build_model,
)
from realtime_stereo_matcher_tpu.train.optim import make_optimizer  # noqa: E402
from realtime_stereo_matcher_tpu.train.trainer import (  # noqa: E402
    TrainState,
    restore_checkpoint,
)
from realtime_stereo_matcher_tpu.utils import colorize as jax_colorize  # noqa: E402
from realtime_stereo_matcher_tpu.utils import pfm as jax_pfm  # noqa: E402
from realtime_stereo_matcher_tpu_torch import evaluate  # noqa: E402
from realtime_stereo_matcher_tpu_torch.data import (  # noqa: E402
    datasets,
    frame_io,
)
from realtime_stereo_matcher_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticStereo,
)
from realtime_stereo_matcher_tpu_torch.eval import validators  # noqa: E402
from realtime_stereo_matcher_tpu_torch.models import build_model  # noqa: E402
from realtime_stereo_matcher_tpu_torch.models.checkpoint import (  # noqa: E402
    load_weights,
    read_state_dict,
)
from realtime_stereo_matcher_tpu_torch.models.convert import (  # noqa: E402
    from_jax_variables,
)
from realtime_stereo_matcher_tpu_torch.utils import (  # noqa: E402
    colorize,
    pfm,
    timing,
)
from test_dataset_families import (  # noqa: E402
    _png,
    make_eth3d,
    make_falling_things,
    make_middlebury_2014,
    make_middlebury_eval3,
    make_sceneflow,
    make_sintel,
    make_tartan_air,
)
from test_eval import _make_kitti  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
WEIGHTS = ROOT / "realtime_stereo_matcher_tpu_torch" / "weights"
HELD_OUT = WEIGHTS / "held_out.json"
# the two trained models: the config of the run that wrote each checkpoint
TRAINED = {
    "v2": dict(
        config="configure/stereo_net_v2_synthetic_56k_resume_config.json",
        checkpoint=("experiments/SYNTH_STEREO_NET_V2/checkpoints/"
                    "SYNTH_STEREO_NET_V2-epoch-44000.ckpt"),
        step=44000,
        weights=("realtime_stereo_matcher_tpu_torch/weights/"
                 "synth_stereo_net_v2-44000.pt")),
    "v3": dict(
        config="configure/stereo_net_v3_synthetic_resume_config.json",
        checkpoint=("experiments/SYNTH_STEREO_NET_V3/checkpoints/"
                    "SYNTH_STEREO_NET_V3-epoch-20001.ckpt"),
        step=20001,
        weights=("realtime_stereo_matcher_tpu_torch/weights/"
                 "synth_stereo_net_v3-20001.pt")),
    "v4": dict(
        config="configure/stereo_net_v4_synthetic_config.json",
        checkpoint=("experiments/SYNTH_STEREO_NET_V4/checkpoints/"
                    "SYNTH_STEREO_NET_V4-epoch-20001.ckpt"),
        step=20001,
        weights=("realtime_stereo_matcher_tpu_torch/weights/"
                 "synth_stereo_net_v4-20001.pt")),
    "dispnetc": dict(
        config="configure/disp_net_c_synthetic_config.json",
        checkpoint=("experiments/SYNTH_DISP_NET_C/checkpoints/"
                    "SYNTH_DISP_NET_C-epoch-20001.ckpt"),
        step=20001,
        weights=("realtime_stereo_matcher_tpu_torch/weights/"
                 "synth_disp_net_c-20001.pt")),
}
# a small v2 for the validators and the entry points (hidden 8, dilations
# (1, 1))
SMALL_V2 = {"type": "MobileStereoNetV2",
            "parameters": {"down_factor": 3, "max_disp": 32, "refine_dim": 7,
                           "refine_dilates": [1, 1], "hidden_dim": 8}}


class JaxRunner(jax_validators.ModelRunner):
    """The JAX package's runner with a constant latency: its chained
    latency costs ~75 CPU forwards a shape, and FPS is never compared."""

    def latency(self, left, right) -> float:
        return 1.0


def train_state_shapes(cfg):
    """(Flax model, the shapes and dtypes of the JAX package's
    ``create_train_state(cfg)``), traced without running its init (an
    unjitted V4 init takes about a minute on the CPU): all that
    ``restore_checkpoint`` reads of its template."""
    model = jax_build_model(cfg.model.as_dict())
    tx, _ = make_optimizer(cfg.train.learn_rate, cfg.train.num_of_steps,
                           cfg.train.weight_decay)
    dummy = jax.numpy.zeros((1, 64, 64, 3), jax.numpy.float32)

    def make(key):
        v = model.init(key, dummy, dummy, train=True)
        return TrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                          params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]))

    return model, jax.eval_shape(make, jax.random.PRNGKey(0))


def restore_trained(name: str):
    """(Flax model, float32 variables as numpy, config) of a committed
    trained checkpoint, restored read-only by the JAX package."""
    spec = TRAINED[name]
    ckpt = ROOT / spec["checkpoint"]
    if not ckpt.is_dir():
        pytest.fail(f"the committed checkpoint {ckpt} is missing")
    cfg = jax_load_config(ROOT / spec["config"])
    model, template = train_state_shapes(cfg)
    state = restore_checkpoint(ckpt, template)
    assert int(state.step) == spec["step"]
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return model, variables, cfg


def port_trained(name: str, variables, device="cpu"):
    """The port model of ``name``'s config with ``variables`` moved in."""
    cfg = jax_load_config(ROOT / TRAINED[name]["config"])
    model = build_model(cfg.model.as_dict(), device=device)
    model.load_state_dict(from_jax_variables(variables))
    return model


def jax_held_out(model, variables) -> dict:
    """The JAX package's ``validate_synthetic`` (Flax, float32) on the 40
    held-out scenes."""
    return jax_validators.validate_synthetic(
        JaxRunner(model, variables, fast=False))


def trained_weights_check(name: str, restored) -> None:
    """The committed port weights of ``name`` equal a fresh conversion of
    the restored orbax checkpoint, tensor for tensor."""
    _, variables, _ = restored
    want = from_jax_variables(variables)
    got = read_state_dict(ROOT / TRAINED[name]["weights"])
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


class _Recording(jax_validators.ModelRunner):
    """``JaxRunner`` keeping each final prediction."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.preds = []

    def __call__(self, left, right):
        out = super().__call__(left, right)
        self.preds.append((np.asarray(left), np.asarray(right),
                           np.asarray(out[-1])))
        return out

    latency = JaxRunner.latency


class _PortRecording:
    """A port ``ModelRunner`` keeping each final prediction, with a constant
    latency as ``JaxRunner`` has (FPS is never compared)."""

    def __init__(self, runner):
        self.runner, self.device, self.preds = runner, runner.device, []

    def __call__(self, left, right):
        out = self.runner(left, right)
        self.preds.append(out[-1].numpy())
        return out

    latency = JaxRunner.latency


def trained_held_out_check(name: str, restored) -> None:
    """The port's plain float32 ``validate_synthetic`` (the runner of the
    ``evaluate`` entry point on the CPU) against the JAX package's and
    ``held_out.json`` (see tests/test_torch_port_eval_v2.py)."""
    from realtime_stereo_matcher_tpu_torch.config import load_config

    model, variables, _ = restored
    spec = TRAINED[name]
    runner = evaluate.build_runner(load_config(ROOT / spec["config"]),
                                   str(ROOT / spec["weights"]), device="cpu")
    assert not runner.fast and runner.dtype == torch.float32
    recording = _PortRecording(runner)
    got = validators.validate_synthetic(recording)
    jax_runner = _Recording(model, variables, fast=False)
    want = jax_validators.validate_synthetic(jax_runner)
    held_out = json.loads(HELD_OUT.read_text())[name]
    assert {k: held_out[k] for k in spec} == spec
    for metrics in (got, want):
        for key, tol in (("synthetic-epe", 1e-4), ("synthetic-d1", 1e-2)):
            assert abs(metrics[key] - held_out["validate_synthetic"][key]
                       ) <= tol, (key, metrics[key], held_out)
    assert abs(got["synthetic-epe"] - want["synthetic-epe"]) <= 1e-4
    assert abs(got["synthetic-d1"] - want["synthetic-d1"]) <= 1e-2
    assert len(jax_runner.preds) == len(recording.preds) == 40
    # per pixel on the JAX package's own scenes (the port's differ from
    # cv2's by one level on a few pixels, which moves a prediction by up to
    # 0.25 px there)
    worst = 0.0
    for left, right, flax in jax_runner.preds[:3]:
        port = runner(torch.tensor(left), torch.tensor(right))[-1]
        worst = max(worst, float(np.abs(port.numpy() - flax).max()))
    scenes = max(float(np.abs(a - b[2]).max())
                 for a, b in zip(recording.preds, jax_runner.preds))
    print(f"{name}: largest per-pixel difference from Flax {worst:.3e} px on "
          f"its scenes, {scenes:.3e} px on each package's own")
    assert worst < 1e-2


def trained_pixels_check(name: str, restored, n_scenes: int) -> float:
    """The port's plain float32 runner (the ``evaluate`` entry point's on
    the CPU) against the JAX package's (Flax, float32) on the JAX package's
    own first ``n_scenes`` held-out scenes, padded as ``validate_synthetic``
    pads them: the final prediction within 1e-2 px per pixel.  Returns the
    largest difference."""
    from realtime_stereo_matcher_tpu_torch.config import load_config

    model, variables, _ = restored
    spec = TRAINED[name]
    runner = evaluate.build_runner(load_config(ROOT / spec["config"]),
                                   str(ROOT / spec["weights"]), device="cpu")
    assert not runner.fast and runner.dtype == torch.float32
    jax_runner = JaxRunner(model, variables, fast=False)
    scenes = JaxSyntheticStereo(length=n_scenes, seed0=10 ** 6)
    worst = 0.0
    for i in range(n_scenes):
        _, image1, image2, _, _ = scenes[i]
        left, right, _ = validators._prep(image1, image2)
        want = np.asarray(jax_runner(left.numpy(), right.numpy())[-1])
        got = runner(left, right)[-1].numpy()
        assert got.shape == want.shape == (1, *left.shape[1:3], 1)
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"{name}: largest per-pixel difference from Flax {worst:.3e} px "
          f"on {n_scenes} held-out scenes")
    assert worst < 1e-2
    return worst


def write_weights(names=()) -> None:
    """Write the port's copies of the trained checkpoints ``names`` (all
    when empty) and their JAX held-out metrics (see the module
    docstring)."""
    jax.config.update("jax_platforms", "cpu")
    WEIGHTS.mkdir(exist_ok=True)
    record = json.loads(HELD_OUT.read_text()) if HELD_OUT.exists() else {}
    for name in names or TRAINED:
        spec = TRAINED[name]
        model, variables, _ = restore_trained(name)
        torch.save(from_jax_variables(variables), ROOT / spec["weights"])
        metrics = jax_held_out(model, variables)
        record[name] = dict(
            spec, validate_synthetic={k: metrics[k] for k in
                                      ("synthetic-epe", "synthetic-d1")},
            how=("the JAX package's validate_synthetic: Flax, float32, on "
                 "the CPU, 40 held-out scenes (seeds 10**6 ..), 320 x 448"))
        print(name, record[name]["validate_synthetic"], flush=True)
    HELD_OUT.write_text(json.dumps(record, indent=1) + "\n")


# ---------------------------------------------------------------------------
# utils: PFM and colour
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 11), (7, 11, 1), (7, 11, 3)])
def test_pfm_round_trips_against_jax(tmp_path, rng, shape):
    image = rng.standard_normal(shape).astype(np.float32)
    port_file, jax_file = tmp_path / "port.pfm", tmp_path / "jax.pfm"
    pfm.write_pfm(port_file, image, 2.5)
    jax_pfm.write_pfm(jax_file, image, 2.5)
    assert port_file.read_bytes() == jax_file.read_bytes()
    got, scale = pfm.read_pfm(jax_file)
    want, want_scale = jax_pfm.read_pfm(port_file)
    assert scale == want_scale == 2.5
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, image.reshape(got.shape))
    with pytest.raises(ValueError, match="float32"):
        pfm.write_pfm(port_file, image.astype(np.float64))


def test_colorize_matches_jax(rng):
    mat = rng.uniform(-5, 80, (13, 17)).astype(np.float32)
    mat[0, :4] = 0.0
    for lo, hi in ((1.0, 64.0), (10.0, 100.0), (5.0, 5.0)):
        got = colorize.colorize_2d_matrix(mat, min_val=lo, max_val=hi)
        want = jax_colorize.colorize_2d_matrix(mat, min_val=lo, max_val=hi)
        assert got.dtype == np.uint8 and got.shape == (13, 17, 3)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# data/frame_io.py: each reader on the same file
# ---------------------------------------------------------------------------


def _same(got, want):
    """Readers return arrays, (disp, valid) pairs or PIL images."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_frame_io_pfm_flo_and_images(tmp_path, rng):
    for shape in ((9, 13), (9, 13, 3)):
        path = str(tmp_path / f"x{len(shape)}.pfm")
        jax_pfm.write_pfm(path, rng.standard_normal(shape).astype(np.float32))
        _same(frame_io.read_gen(path), jax_frame_io.read_gen(path))
    uv = rng.standard_normal((9, 13, 2)).astype(np.float32)
    flo = str(tmp_path / "a.flo")
    jax_frame_io.write_flow(flo, uv)
    _same(frame_io.read_flow(flo), jax_frame_io.read_flow(flo))
    _same(frame_io.read_gen(flo), uv)
    bad = tmp_path / "bad.flo"
    bad.write_bytes(np.zeros(8, np.float32).tobytes())
    assert frame_io.read_flow(bad) is None is jax_frame_io.read_flow(bad)
    png = tmp_path / "im.png"
    _png(png, rng)
    _same(frame_io.read_gen(str(png)), jax_frame_io.read_gen(str(png)))
    assert frame_io.read_gen(str(tmp_path / "x.txt")) == []


def test_frame_io_kitti_png(tmp_path, rng):
    root = _make_kitti(tmp_path, rng, n=1)
    disp = str(root / "training/disp_occ_0/000000_10.png")
    _same(frame_io.read_disp_kitti(disp), jax_frame_io.read_disp_kitti(disp))


@pytest.mark.parametrize("family", ["sintel", "falling_things", "tartan_air",
                                    "middlebury_2014", "middlebury_F"])
def test_frame_io_dataset_readers(tmp_path, rng, family):
    if family == "sintel":
        make_sintel(tmp_path, rng)
        path, reader = ("training/disparities/alley_1/frame_0001.png",
                        "read_disp_sintel")
    elif family == "falling_things":
        make_falling_things(tmp_path, rng)
        path, reader = ("single/obj/000000.left.depth.png",
                        "read_disp_falling_things")
    elif family == "tartan_air":
        make_tartan_air(tmp_path, rng)
        path, reader = ("abandonedfactory/Easy/P000/depth_left/"
                        "000000_left_depth.npy", "read_disp_tartan_air")
    elif family == "middlebury_2014":
        make_middlebury_2014(tmp_path, rng)
        path, reader = "2014/Scene_0/disp0.pfm", "read_disp_middlebury"
    else:
        make_middlebury_eval3(tmp_path, rng)
        path, reader = ("MiddEval3/trainingF/Scene_0/disp0GT.pfm",
                        "read_disp_middlebury")
    path = str(tmp_path / path)
    _same(getattr(frame_io, reader)(path), getattr(jax_frame_io, reader)(path))


# ---------------------------------------------------------------------------
# data/datasets.py and SyntheticStereo
# ---------------------------------------------------------------------------


def _same_samples(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds)
    for i in range(len(jax_ds)):
        got, want = port_ds[i], jax_ds[i]
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("family", ["sceneflow", "sceneflow_things_test",
                                    "eth3d", "sintel", "falling_things",
                                    "tartan_air", "kitti", "middlebury_2014",
                                    "middlebury_F"])
def test_dataset_classes_match_jax(tmp_path, rng, family):
    root = str(tmp_path)
    if family.startswith("sceneflow"):
        make_sceneflow(tmp_path, rng)
        make_sceneflow(tmp_path, rng, dstype="frames_finalpass")
        kw = (dict(dstype="frames_finalpass", things_test=True)
              if family == "sceneflow_things_test" else {})
        cls, kw = "SceneFlowDatasets", dict(kw, root=root)
    elif family == "eth3d":
        make_eth3d(tmp_path, rng)
        cls, kw = "ETH3D", dict(root=root)
    elif family == "sintel":
        make_sintel(tmp_path, rng)
        cls, kw = "SintelStereo", dict(root=root)
    elif family == "falling_things":
        make_falling_things(tmp_path, rng)
        cls, kw = "FallingThings", dict(root=root)
    elif family == "tartan_air":
        make_tartan_air(tmp_path, rng)
        cls, kw = "TartanAir", dict(root=root, keywords=("abandoned",))
    elif family == "kitti":
        _make_kitti(tmp_path, rng)
        cls, kw = "KITTI", dict(root=root + "/KITTI")
    elif family == "middlebury_2014":
        make_middlebury_2014(tmp_path, rng)
        cls, kw = "Middlebury", dict(root=root, split="2014")
    else:
        make_middlebury_eval3(tmp_path, rng)
        cls, kw = "Middlebury", dict(root=root, split="F")
    port_ds = getattr(datasets, cls)(aug_params=None, **kw)
    jax_ds = getattr(jax_datasets, cls)(aug_params=None, **kw)
    assert len(jax_ds) > 0
    _same_samples(port_ds, jax_ds)
    # evaluation's aug_params={}: no augmentor in either package
    _same_samples(getattr(datasets, cls)(aug_params={}, **kw),
                  getattr(jax_datasets, cls)(aug_params={}, **kw))
    _same_samples(port_ds * 2 + port_ds, jax_ds * 2 + jax_ds)
    # training augmentation (a crop: the host augmentors; a pad), with the
    # same per-sample rng in both packages: the same samples, bit for bit
    for aug in (dict(crop_size=(48, 64), min_scale=0.0, max_scale=0.2),
                dict(img_pad=(2, 3))):
        port_aug = getattr(datasets, cls)(aug_params=dict(aug), **kw)
        jax_aug = getattr(jax_datasets, cls)(aug_params=dict(aug), **kw)
        for i in range(len(jax_aug)):
            got = port_aug.get(i, np.random.default_rng(i))
            want = jax_aug.get(i, np.random.default_rng(i))
            assert got[0] == want[0]
            for g, w in zip(got[1:], want[1:]):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def test_synthetic_stereo_matches_jax():
    """Sample for sample: names, flow and validity exact; images within 1
    level on at most 1e-3 of the values (the port's numpy resize against
    cv2's; tests/test_torch_port_train_step.py measured <= 1.1e-4)."""
    kw = dict(aug_params=None, length=4, seed0=10 ** 6, image_hw=(96, 128),
              max_disp=48.0)
    port_ds, jax_ds = SyntheticStereo(**kw), JaxSyntheticStereo(**kw)
    assert len(port_ds) == len(jax_ds) == 4
    for i in range(5):  # index 4 wraps to 0, as in the JAX package
        got, want = port_ds[i], jax_ds[i]
        assert got[0] == want[0]
        for g, w in zip(got[3:], want[3:]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got[1:3], want[1:3]):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            diff = np.abs(g - w)
            assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-3
    assert port_ds.extra_info == jax_ds.extra_info
    assert len(port_ds * 3) == len(jax_ds * 3) == 12
    # with the host augmentor, on the JAX package's scenes and the same
    # per-sample rng: the same crops, bit for bit (the port's resize
    # computes cv2's)
    aug = dict(crop_size=(48, 64), min_scale=-0.2, max_scale=0.4)
    port_aug = SyntheticStereo(**dict(kw, aug_params=dict(aug)))
    jax_aug = JaxSyntheticStereo(**dict(kw, aug_params=dict(aug)))
    port_aug._cache = {i: jax_make_scene(10 ** 6 + i, 96, 128, max_disp=48.0)
                       for i in range(4)}
    for i in range(4):
        got = port_aug.get(i, np.random.default_rng(i))
        want = jax_aug.get(i, np.random.default_rng(i))
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("hw", [(64, 64), (65, 130), (96, 128), (320, 448),
                                (375, 1242), (436, 1024)])
def test_prep_pads_as_jax(rng, hw):
    """Validation pads each frame to /64 with the replicate-mode centred
    padder, as the JAX package does without its ``shape_bucket``, and
    unpads the prediction back to the frame."""
    image1, image2 = (rng.uniform(0, 255, (*hw, 3)).astype(np.float32)
                      for _ in range(2))
    got1, got2, padder = validators._prep(image1, image2)
    want1, want2, jax_padder = jax_validators._prep(image1, image2)
    assert got1.shape[1] % 64 == 0 and got1.shape[2] % 64 == 0
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    np.testing.assert_array_equal(padder.unpad(got1).numpy()[0], image1)
    np.testing.assert_array_equal(
        padder.unpad(got1).numpy(), np.asarray(jax_padder.unpad(want1)))


# ---------------------------------------------------------------------------
# forward_latency and checkpoints
# ---------------------------------------------------------------------------


def test_forward_latency_on_the_cpu():
    calls = []
    t = timing.forward_latency(lambda a, b: calls.append(1), torch.zeros(1),
                               torch.zeros(1), iters=4, warmup=2)
    assert t >= 0 and len(calls) == 6
    with pytest.raises(ValueError, match="iters"):
        timing.forward_latency(lambda a, b: None, torch.zeros(1),
                               torch.zeros(1), iters=0)


def test_load_weights_reads_each_format(tmp_path):
    import gzip

    from realtime_stereo_matcher_tpu.models.torch_import import (
        load_torch_checkpoint,
    )
    from realtime_stereo_matcher_tpu_torch.config import load_config
    from realtime_stereo_matcher_tpu_torch.train.trainer import (
        create_train_state,
        save_checkpoint,
    )

    sd = build_model(SMALL_V2, device="cpu",
                     generator=torch.Generator().manual_seed(3)).state_dict()
    cfg = load_config({"model": SMALL_V2, "train": {}})
    _, _, _, state = create_train_state(cfg, device="cpu")
    save_checkpoint(tmp_path / "trainer.pt", state)
    torch.save(sd, tmp_path / "plain.pt")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               tmp_path / "ref.pth")
    with gzip.open(tmp_path / "ref.pth.gz", "wb") as f:
        f.write((tmp_path / "ref.pth").read_bytes())
    for name, want in (("trainer.pt", state.model.state_dict()),
                       ("plain.pt", sd), ("ref.pth", sd),
                       ("ref.pth.gz", sd)):
        model = load_weights(tmp_path / name, build_model(SMALL_V2,
                                                          device="cpu"))
        got = model.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (name, k)
    # the JAX package reads the reference files into the same arrays
    for name in ("ref.pth", "ref.pth.gz"):
        jax_sd = load_torch_checkpoint(str(tmp_path / name))
        port_sd = read_state_dict(tmp_path / name)
        assert {k.removeprefix("module.") for k in jax_sd} == set(port_sd)
        for k, v in jax_sd.items():
            np.testing.assert_array_equal(
                port_sd[k.removeprefix("module.")].numpy(), v)
    with pytest.raises(ValueError, match="from_jax_variables"):
        load_weights(ROOT / TRAINED["v2"]["checkpoint"],
                     build_model(SMALL_V2, device="cpu"))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_weights(tmp_path / "plain.pt",
                     build_model({"type": "MobileStereoNet", "parameters": {}},
                                 device="cpu"))


def test_load_weights_refuses_pickled_code(tmp_path):
    torch.save({"model": {"w": torch.zeros(1)}, "code": _Pickled()},
               tmp_path / "bad.pt")
    with pytest.raises(Exception, match="weights_only"):
        read_state_dict(tmp_path / "bad.pt")


class _Pickled:
    """An object ``torch.load(weights_only=True)`` must refuse."""


@pytest.mark.parametrize("config", sorted(
    p.name for p in (ROOT / "configure").glob("*.json")))
def test_is_neural_matches_jax(config):
    from realtime_stereo_matcher_tpu.models import is_neural as jax_is_neural
    from realtime_stereo_matcher_tpu_torch.config import load_config
    from realtime_stereo_matcher_tpu_torch.models import is_neural

    model = load_config(ROOT / "configure" / config).model.as_dict()
    assert is_neural(model) == jax_is_neural(model)
    if is_neural(model):  # every neural model of the repo is ported
        build_model(model, device="cpu")
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build_model(model, device="cpu")


if __name__ == "__main__":
    if sys.argv[1:2] != ["--write-weights"] or not set(sys.argv[2:]) <= set(
            TRAINED):
        sys.exit("usage: python tests/test_torch_port_eval.py "
                 f"--write-weights [{' '.join(TRAINED)}]")
    write_weights(sys.argv[2:])
