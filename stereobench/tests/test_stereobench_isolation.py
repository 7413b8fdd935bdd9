"""Nothing the benchmark runs loads JAX or the JAX package, judged by whole
top-level names; the reference loads nothing of the port; a run without a
card, or without the program, fails and prints no result."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from stereobench import isolation
from stereobench.run import ROOT

BENCH = ROOT / "stereobench"
PORT = "realtime_stereo_matcher_tpu_torch"


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(under: pathlib.Path):
    return [p for p in under.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_whole_top_level_names():
    assert isolation.top_level("realtime_stereo_matcher_tpu.models") == \
        "realtime_stereo_matcher_tpu"
    assert isolation.forbidden_loaded([PORT, f"{PORT}.models", "jaxtyping",
                                       "flaxen"]) == []
    assert isolation.forbidden_loaded(["jax.numpy", "optax",
                                       "realtime_stereo_matcher_tpu.ops"]) == [
        "jax", "optax", "realtime_stereo_matcher_tpu"]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {(p.name, m) for p in _sources(BENCH) for m in _imports(p)
             if isolation.top_level(m) in isolation.FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_port():
    found = {(p.name, m) for p in _sources(BENCH / "reference")
             for m in _imports(p) if isolation.top_level(m) == PORT}
    assert not found


def test_the_blocker_refuses_jax():
    code = ("from stereobench import isolation; isolation.block()\n"
            "try:\n    import jax\nexcept ImportError as e:\n    print('refused', e)\n"
            "import realtime_stereo_matcher_tpu_torch.models\n"
            "print(isolation.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "refused" in out.stdout and out.stdout.strip().endswith("[]")


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import stereobench.run, stereobench.loops.camera, stereobench.loops.train, "
            "stereobench.calibrate, stereobench.sweep\n"
            "import realtime_stereo_matcher_tpu_torch.models.fast_infer\n"
            "from stereobench import isolation; print(isolation.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", "stereobench.run", "--workload",
                           "v2-720p-rigs4", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, text=True,
                          capture_output=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_a_run_without_the_program_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "stereobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
