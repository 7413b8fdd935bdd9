"""The port's classical SGBM baseline against the JAX package's, on the CPU.

* ``sgbm_compute`` and ``SGBMModule`` give the JAX package's maps bit for
  bit on seeded pairs, with the SGBM config's parameters and with
  ``tests/test_sgbm.py``'s, and on the JAX package's own first held-out
  synthetic scenes; the grey conversion keeps the reference's BGR-on-RGB
  quirk; torch inputs (the runner's) give the numpy ones' maps;
* ``build_runner`` builds a runner for ``configure/opencv_sgbm_config.json``
  and ``evaluate`` / ``run_validation`` take it; ``fast=True`` refuses it;
* ``validate_synthetic`` with SGBM (``num_of_disps=80``, the anchor of
  BASELINE.md) on the first 3 held-out scenes: the port's numbers are
  ``weights/held_out.json``'s ``sgbm`` entry exactly, and the JAX
  package's run on its own scenes is that entry's ``jax`` numbers exactly.
  The two differ slightly because the port's scenes differ from the JAX
  package's cv2-made ones by one level on a few pixels
  (``data/synthetic.py``); on the same images the maps are bit-equal;
* a failed g++ build raises with the compiler's output.

Run as ``python tests/test_torch_port_sgbm.py --write-held-out`` it writes
the ``sgbm`` entry of ``held_out.json`` (the other entries kept).
"""

import dataclasses
import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # run as a script from any directory
    sys.path.insert(0, str(ROOT))

from realtime_stereo_matcher_tpu.classical.sgbm import (  # noqa: E402
    SGBMModule as JaxSGBMModule,
    bgr2gray_like_reference as jax_bgr2gray,
    sgbm_compute as jax_sgbm_compute,
)
from realtime_stereo_matcher_tpu.data.synthetic import (  # noqa: E402
    SyntheticStereo as JaxSyntheticStereo,
)
from realtime_stereo_matcher_tpu.eval.validators import (  # noqa: E402
    ModelRunner as JaxModelRunner,
    validate_synthetic as jax_validate_synthetic,
)
from realtime_stereo_matcher_tpu_torch.classical import sgbm as port_sgbm  # noqa: E402
from realtime_stereo_matcher_tpu_torch.classical.sgbm import (  # noqa: E402
    SGBMModule,
    bgr2gray_like_reference,
    sgbm_compute,
)
from realtime_stereo_matcher_tpu_torch.config import load_config  # noqa: E402
from realtime_stereo_matcher_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticStereo,
)
from realtime_stereo_matcher_tpu_torch.eval.validators import (  # noqa: E402
    ModelRunner,
    run_validation,
    validate_synthetic,
)
from realtime_stereo_matcher_tpu_torch.evaluate import build_runner  # noqa: E402
from realtime_stereo_matcher_tpu_torch.utils import native_build  # noqa: E402

CONFIG = ROOT / "configure" / "opencv_sgbm_config.json"
HELD_OUT = ROOT / "realtime_stereo_matcher_tpu_torch" / "weights" / "held_out.json"
# BASELINE.md's anchor: SGBM at num_of_disps=80 on the held-out scenes
ANCHOR = {"num_of_disps": 80}
N_SCENES = 3
# tests/test_sgbm.py's parameter sets
TEST_SGBM_KW = [dict(num_of_disps=32, speckle_win_size=0, uniqueness_ratio=10),
                dict(min_disp=0, num_of_disps=32, block_size=5, p1=216,
                     p2=864, pre_filter_cap=63, uniqueness_ratio=10,
                     speckle_win_size=100, speckle_range=2,
                     disp12_max_diff=1, mode=1)]


def config_params() -> dict:
    return json.loads(CONFIG.read_text())["model"]["parameters"]


def _pair(seed, h=72, w=120, disp=9):
    """A textured grey pair with a constant shift (tests/test_sgbm.py's
    make_pair) and an RGB version of it."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 255, size=(h, w + disp + 8), dtype=np.uint8)
    tex = ((tex.astype(np.float32) + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))
           / 3).astype(np.uint8)
    return tex[:, :w], tex[:, disp:disp + w]


@pytest.mark.parametrize("kw", [config_params(), *TEST_SGBM_KW],
                         ids=["config", "test_sgbm_1", "test_sgbm_2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sgbm_compute_is_the_jax_packages(kw, seed):
    left, right = _pair(seed)
    got, want = sgbm_compute(left, right, **kw), jax_sgbm_compute(left, right,
                                                                  **kw)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kw", [config_params(), TEST_SGBM_KW[1]],
                         ids=["config", "test_sgbm_2"])
def test_sgbm_module_is_the_jax_packages(kw):
    rng = np.random.default_rng(3)
    left = rng.uniform(0, 255, (2, 64, 96, 3)).astype(np.float32)
    right = np.roll(left, -5, axis=2)
    got = SGBMModule(**kw)(left, right)
    want = JaxSGBMModule(**kw)(left, right)
    assert len(got) == len(want) == 1
    assert got[0].shape == want[0].shape == (2, 64, 96, 1)
    assert np.array_equal(got[0], want[0])
    # a torch batch (on any device) gives the same maps
    again = SGBMModule(**kw)(torch.from_numpy(left), torch.from_numpy(right))
    assert np.array_equal(again[0], got[0])


def test_grey_keeps_the_bgr_on_rgb_quirk():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (8, 12, 3)).astype(np.float32)
    got = bgr2gray_like_reference(img)
    assert np.array_equal(got, jax_bgr2gray(img))
    assert np.array_equal(got, (0.114 * img[..., 0] + 0.587 * img[..., 1]
                                + 0.299 * img[..., 2]).astype(np.uint8))


def test_sgbm_on_the_jax_scenes_is_the_jax_packages():
    """The JAX package's first held-out scenes (its own, cv2-made images)
    through both modules: the same maps, bit for bit."""
    scenes = JaxSyntheticStereo(aug_params=None, length=N_SCENES,
                                seed0=10 ** 6, image_hw=(320, 448),
                                max_disp=64.0)
    for i in range(N_SCENES):
        _, left, right, _, _ = scenes[i]
        left, right = np.asarray(left)[None], np.asarray(right)[None]
        assert np.array_equal(SGBMModule(**ANCHOR)(left, right)[0],
                              JaxSGBMModule(**ANCHOR)(left, right)[0])


def port_held_out() -> dict:
    metrics = validate_synthetic(ModelRunner(SGBMModule(**ANCHOR),
                                             device="cpu"),
                                 n_images=N_SCENES)
    return {k: metrics[k] for k in ("synthetic-epe", "synthetic-d1")}


def port_maps_sha256() -> str:
    """sha256 of the port's SGBM maps of the first held-out scenes (float32
    bytes, scene after scene): the native matcher is integer arithmetic, so
    every machine gives these bits."""
    scenes = SyntheticStereo(aug_params=None, length=N_SCENES, seed0=10 ** 6,
                             image_hw=(320, 448), max_disp=64.0)
    digest = hashlib.sha256()
    for i in range(N_SCENES):
        _, left, right, _, _ = scenes[i]
        disp = SGBMModule(**ANCHOR)(np.asarray(left)[None],
                                    np.asarray(right)[None])[0]
        digest.update(np.ascontiguousarray(disp, np.float32).tobytes())
    return digest.hexdigest()


def jax_held_out() -> dict:
    metrics = jax_validate_synthetic(JaxModelRunner(JaxSGBMModule(**ANCHOR)),
                                     n_images=N_SCENES)
    return {k: metrics[k] for k in ("synthetic-epe", "synthetic-d1")}


def _assert_metrics(got: dict, want: dict):
    """The same metrics up to numpy's float32 mean, whose sum order follows
    the host's SIMD width: within 1e-6 relative."""
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), (k, got, want)


def test_held_out_metrics_are_the_recorded_ones():
    entry = json.loads(HELD_OUT.read_text())["sgbm"]
    assert entry["parameters"] == ANCHOR and entry["scenes"] == N_SCENES
    assert port_maps_sha256() == entry["maps_sha256"]
    _assert_metrics(port_held_out(), entry["validate_synthetic"])
    jax = jax_held_out()
    _assert_metrics(jax, entry["jax"])
    # the scenes differ on a few pixels by one level: the metrics barely
    for k in jax:
        assert abs(jax[k] - entry["validate_synthetic"][k]) < 1e-3


def test_runner_takes_the_sgbm_config():
    cfg = load_config(CONFIG)
    runner = build_runner(cfg, "", device="cpu")
    assert not runner.is_neural and isinstance(runner.model, SGBMModule)
    assert (dataclasses.asdict(runner.model)
            == dataclasses.asdict(JaxSGBMModule(**config_params())))
    rng = np.random.default_rng(5)
    left = torch.from_numpy(rng.uniform(0, 255, (1, 48, 64, 3))
                            .astype(np.float32))
    out = runner(left, torch.roll(left, -3, dims=2))
    assert len(out) == 1 and out[0].shape == (1, 48, 64, 1)
    assert out[0].device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="no kernel path"):
        ModelRunner(SGBMModule(), fast=True, device="cpu")
    with pytest.raises(ValueError, match="unknown test dataset"):
        run_validation(runner, ["nowhere"])


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(native_build, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="native build failed for "
                                           "broken.cpp:\n.*error"):
        native_build.build_native("broken.cpp")
    assert not list((tmp_path / "_build").glob("*.so"))


def test_build_is_cached_by_source_and_flags():
    path = native_build.build_native("sgbm.cpp")
    assert path.parent == native_build.BUILD_DIR
    assert native_build.build_native("sgbm.cpp") == path
    assert port_sgbm._load() is port_sgbm._load()


def write_held_out() -> None:
    held_out = json.loads(HELD_OUT.read_text())
    held_out["sgbm"] = {
        "config": str(CONFIG.relative_to(ROOT)),
        "parameters": ANCHOR,
        "scenes": N_SCENES,
        "validate_synthetic": port_held_out(),
        "maps_sha256": port_maps_sha256(),
        "jax": jax_held_out(),
        "how": ("validate_synthetic of the port (its scenes) and of the JAX "
                "package (its cv2-made scenes) with SGBM at "
                "num_of_disps=80 on the CPU, the first 3 held-out scenes "
                "(seeds 10**6 ..), 320 x 448"),
    }
    HELD_OUT.write_text(json.dumps(held_out, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-held-out"]:
        sys.exit("usage: python tests/test_torch_port_sgbm.py "
                 "--write-held-out")
    write_held_out()
