"""The PyTorch port stands alone: no JAX, no JAX package, no silent CPU path.

The machine with the card has PyTorch, Triton and the CUDA toolkit but no
JAX, so nothing under ``realtime_stereo_matcher_tpu_torch/`` and nothing in
``chip_smoke.py`` may import ``jax``, ``jaxlib``, ``flax``, ``optax``,
``orbax`` or the JAX package ``realtime_stereo_matcher_tpu``, even
indirectly.  This file imports neither, so it also runs on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_isolation.py

(``--noconftest`` because tests/conftest.py imports JAX.)
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "realtime_stereo_matcher_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "realtime_stereo_matcher_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py"))


def _module_names():
    return [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__") for p in _port_files()]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_banned_import_in_source():
    files = _port_files() + [SMOKE]
    assert len(files) > 15
    for path in files:
        found = _imported_roots(path) & set(BANNED)
        assert not found, f"{path.relative_to(ROOT)} imports {sorted(found)}"


# the training slice's modules, named so that a rename cannot drop one from
# the blocked import below unnoticed
TRAIN_MODULES = (
    "realtime_stereo_matcher_tpu_torch.config",
    "realtime_stereo_matcher_tpu_torch.data.synthetic",
    "realtime_stereo_matcher_tpu_torch.kernels.train_conv",
    "realtime_stereo_matcher_tpu_torch.kernels.train_conv3d",
    "realtime_stereo_matcher_tpu_torch.models.fast_train",
    "realtime_stereo_matcher_tpu_torch.train.init",
    "realtime_stereo_matcher_tpu_torch.train.loss",
    "realtime_stereo_matcher_tpu_torch.train.optim",
    "realtime_stereo_matcher_tpu_torch.train.trainer",
)


# the v3 slice's modules, named for the same reason
V3_MODULES = (
    "realtime_stereo_matcher_tpu_torch.kernels.unet",
    "realtime_stereo_matcher_tpu_torch.kernels.refine_stack",
    "realtime_stereo_matcher_tpu_torch.ops.sampling",
    "realtime_stereo_matcher_tpu_torch.models.stereo_net",
    "realtime_stereo_matcher_tpu_torch.models.fast_infer",
)


# the evaluation slice's modules, named for the same reason
EVAL_MODULES = (
    "realtime_stereo_matcher_tpu_torch.data.datasets",
    "realtime_stereo_matcher_tpu_torch.data.frame_io",
    "realtime_stereo_matcher_tpu_torch.eval.validators",
    "realtime_stereo_matcher_tpu_torch.evaluate",
    "realtime_stereo_matcher_tpu_torch.infer",
    "realtime_stereo_matcher_tpu_torch.models.checkpoint",
    "realtime_stereo_matcher_tpu_torch.utils.colorize",
    "realtime_stereo_matcher_tpu_torch.utils.pfm",
    "realtime_stereo_matcher_tpu_torch.utils.timing",
)


# the training-data slice's modules, named for the same reason
TRAIN_DATA_MODULES = (
    "realtime_stereo_matcher_tpu_torch.data.augment",
    "realtime_stereo_matcher_tpu_torch.data.device_augment",
    "realtime_stereo_matcher_tpu_torch.data.device_cache",
    "realtime_stereo_matcher_tpu_torch.data.loader",
    "realtime_stereo_matcher_tpu_torch.train.freeze",
    "realtime_stereo_matcher_tpu_torch.train_stereo",
    "realtime_stereo_matcher_tpu_torch.utils.logger",
)


# the V4 and DispNetC slice's modules, named for the same reason
V4_DISPNETC_MODULES = (
    "realtime_stereo_matcher_tpu_torch.models.disp_net_c",
    "realtime_stereo_matcher_tpu_torch.models.layers",
    "realtime_stereo_matcher_tpu_torch.models.convert",
    "realtime_stereo_matcher_tpu_torch.models.stereo_net_v4",
    "realtime_stereo_matcher_tpu_torch.ops.cost_volume",
    "realtime_stereo_matcher_tpu_torch.train.init",
)


# the data-parallel slice's modules, named for the same reason
PARALLEL_MODULES = (
    "realtime_stereo_matcher_tpu_torch.parallel",
    "realtime_stereo_matcher_tpu_torch.parallel.comm_audit",
    "realtime_stereo_matcher_tpu_torch.parallel.distributed",
    "realtime_stereo_matcher_tpu_torch.parallel.mesh",
    "realtime_stereo_matcher_tpu_torch.parallel.scaling_bench",
)


def test_imports_with_jax_blocked():
    """Every port module and chip_smoke import with the banned names made
    unimportable, so no import reaches them, directly or transitively."""
    assert set(TRAIN_MODULES) <= set(_module_names())
    assert set(V3_MODULES) <= set(_module_names())
    assert set(EVAL_MODULES) <= set(_module_names())
    assert set(TRAIN_DATA_MODULES) <= set(_module_names())
    assert set(V4_DISPNETC_MODULES) <= set(_module_names())
    assert set(PARALLEL_MODULES) <= set(_module_names())
    code = (
        "import importlib, sys\n"
        f"banned = {BANNED!r}\n"
        "for name in list(sys.modules):\n"
        "    if name.split('.')[0] in banned:\n"
        "        sys.modules[name] = None\n"
        "for name in banned:\n"
        "    sys.modules[name] = None\n"
        f"for name in {_module_names() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "print('imported all')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "imported all" in proc.stdout


def test_synthetic_eval_needs_no_pil_or_cv2():
    """The card's machine has neither PIL nor cv2: with both (and JAX)
    unimportable, every port module imports, and a small v2 runs the
    synthetic validation on the CPU; PIL is imported only where PNG or JPG
    files are read or written."""
    code = (
        "import importlib, sys\n"
        f"for name in {BANNED + ('PIL', 'cv2')!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        "from realtime_stereo_matcher_tpu_torch.eval import validators\n"
        "from realtime_stereo_matcher_tpu_torch.models import build_model\n"
        "model = build_model({'type': 'MobileStereoNetV2', 'parameters': "
        "{'max_disp': 32, 'refine_dilates': [1, 1], 'hidden_dim': 8}}, "
        "device='cpu')\n"
        "r = validators.validate_synthetic(validators.ModelRunner("
        "model, device='cpu'), n_images=1, image_hw=(64, 96))\n"
        "print('epe', r['synthetic-epe'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "epe " in proc.stdout


def test_training_data_path_needs_no_pil_cv2_or_tensorboard(tmp_path):
    """With JAX, PIL, cv2 and TensorBoard unimportable, the training-data
    modules import and run on the CPU: a synthetic pack held on the
    device, an index batch augmented there, the host augmentor (its own
    resize) and the loader over augmented scenes, and the metric logger,
    which then writes only its JSONL file."""
    code = (
        "import importlib, sys\n"
        f"for name in {BANNED + ('PIL', 'cv2', 'torch.utils.tensorboard')!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {TRAIN_DATA_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import numpy as np, torch\n"
        "from realtime_stereo_matcher_tpu_torch.data import (\n"
        "    device_augment, device_cache, loader, synthetic)\n"
        "from realtime_stereo_matcher_tpu_torch.utils.logger import "
        "MetricLogger\n"
        "ds = synthetic.SyntheticStereo(length=2, image_hw=(48, 64))\n"
        "res = device_cache.DeviceResidentScenes(\n"
        "    device_cache.pack_synthetic(ds, cache_dir=None), device='cpu')\n"
        "spec = device_augment.AugmentSpec(src_hw=(48, 64), "
        "crop_size=(32, 40))\n"
        "out = device_augment.make_device_augment(spec)(\n"
        "    0, *res.fetch(torch.tensor([1, 0])))\n"
        "aug = synthetic.SyntheticStereo(dict(crop_size=(32, 40)), length=2,"
        " image_hw=(48, 64))\n"
        "batch = next(iter(loader.StereoDataLoader(aug, 2, num_workers=1)))\n"
        f"log = MetricLogger({str(tmp_path)!r}, sum_freq=1)\n"
        "log.push({'live_loss': 1.0}, step=0)\n"
        "log.close()\n"
        "print('shapes', tuple(out[0].shape), batch[1].shape, log._tb)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "shapes (2, 32, 40, 3) (2, 32, 40, 3) None" in proc.stdout
    assert (tmp_path / "scalars.jsonl").read_text().count("\n") == 1


def _run_smoke(cwd):
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stdout


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    rc, out = _run_smoke(ROOT)
    assert rc != 0
    assert '"ok": true' not in out
    # alone in a directory, without the rest of the repo, it fails too
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    rc, out = _run_smoke(tmp_path)
    assert rc != 0
    assert '"ok": true' not in out


def test_bench_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from realtime_stereo_matcher_tpu_torch import bench

    assert bench.main([]) == 1
    assert bench.main(["--model", "v3"]) == 1
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run_bench(pairs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run_bench(pairs=1, model="v3")


def test_kernel_sources_have_no_torch_headers_and_target_sm90a():
    from realtime_stereo_matcher_tpu_torch.kernels import _build

    sources = sorted((PORT / "csrc").glob("*.cu*"))
    assert {p.name for p in sources} >= {"conv3x3.cu", "conv3d.cu",
                                         "dw_reduce.cu"}
    for p in sources:
        text = p.read_text()
        assert "torch/extension.h" not in text and "ATen" not in text, p
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.LINK_FLAGS
    assert "-shared" in _build.LINK_FLAGS
    # the library lands in a directory git ignores
    assert _build.library_path().parent == PORT / "_build"
    assert "realtime_stereo_matcher_tpu_torch/_build/" in (
        ROOT / ".gitignore").read_text().splitlines()


@pytest.mark.cuda
def test_kernels_on_cuda_match_plain():
    """On the card: each kernel against its plain version at small, odd,
    batch-2 shapes, and the launches counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from realtime_stereo_matcher_tpu_torch.kernels import LAUNCHES
    from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
        fused_conv3x3,
        fused_conv3x3_plain,
        fused_conv4x4_s2,
        fused_conv4x4_s2_plain,
    )
    from realtime_stereo_matcher_tpu_torch.kernels.cost_filter3d import (
        fused_conv3d,
        fused_conv3d_plain,
    )

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda") * 2 - 1

    LAUNCHES.clear()
    for stride, dil, cin, cout, act, res in [(1, 1, 32, 32, "relu", True),
                                             (1, 8, 32, 32, "relu", False),
                                             (1, 1, 4, 32, 0.2, False),
                                             (1, 1, 3, 32, 0.2, False),
                                             (1, 1, 32, 1, "none", False),
                                             (2, 1, 3, 32, "relu", False)]:
        x, w = rand(2, 37, 70, cin), rand(3, 3, cin, cout) * 0.2
        scale, bias = rand(cout) + 1.5, rand(cout)
        ho, wo = (37 - 1) // stride + 1, (70 - 1) // stride + 1
        r = rand(2, ho, wo, cout) if res else None
        kw = dict(stride=stride, dilation=dil, act=act, residual=r)
        got = fused_conv3x3(x, w, scale, bias, **kw)
        want = fused_conv3x3_plain(x, w, scale, bias, **kw)
        # float32 sums in another order than cuDNN's
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    x, w = rand(2, 5, 9, 14, 32), rand(3, 3, 3, 32, 32) * 0.1
    s, b = rand(32) + 1.5, rand(32)
    torch.testing.assert_close(fused_conv3d(x, w, s, b),
                               fused_conv3d_plain(x, w, s, b),
                               atol=1e-3, rtol=1e-3)
    # the 4x4 stride-2 TF-SAME conv at an odd size (37 x 70 -> 19 x 35)
    x, w = rand(2, 37, 70, 32), rand(4, 4, 32, 32) * 0.2
    torch.testing.assert_close(fused_conv4x4_s2(x, w, s, b, act=0.2),
                               fused_conv4x4_s2_plain(x, w, s, b, act=0.2),
                               atol=1e-3, rtol=1e-3)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"fused_conv3x3": 5, "fused_conv3x3_s2": 1,
                              "fused_conv4x4_s2": 1, "fused_conv3d": 1}
    with pytest.raises(ValueError, match="not instantiated"):
        fused_conv3x3(rand(1, 8, 8, 16), rand(3, 3, 16, 16), s[:16], b[:16])
    with pytest.raises(ValueError, match="contiguous"):
        xt = rand(1, 8, 8, 32).transpose(1, 2)
        fused_conv3x3(xt, rand(3, 3, 32, 32), s, b)


def test_cuda_marker_is_registered():
    ini = (ROOT / "pytest.ini").read_text()
    assert "cuda:" in ini
    assert os.path.exists(ROOT / "chip_smoke.py")
