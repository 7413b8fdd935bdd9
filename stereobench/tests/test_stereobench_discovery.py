"""A configuration (with its own reference module), a cell, a traffic mix
and a metric are taken by name from new files, with no edit to a file that
is there; a CPU run of a small cell goes through the whole harness."""

import json
import shutil
import time

import pytest
import torch

from stereobench import run
from stereobench.run import ROOT


# appended to the new reference module: which devices its build served
_COUNTED_BUILD = """

BUILDS = []
_build = build


def build(model_config, device="cpu"):
    BUILDS.append(str(device))
    return _build(model_config, device)
"""


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark's files, with one new cell, traffic mix and
    per-layer metric, and one new configuration (its file and its own
    reference module, a copy of v3's that counts its builds) with a cell,
    added as new files and new entries."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "stereobench", tmp_path / "stereobench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "v2-tiny-new", "config": "mobilestereonet-v2",
                               "traffic": "tiny-new", "chips": 1,
                               "why": "a cell added by files alone"})
    bench["per_layer"].append({"name": "answered_share.new", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "frame_p95_ms",
                               "workloads": ["v2-tiny-new"]})
    bench["configs"].append({"name": "v3-own-reference", "source": "a test",
                             "file": "stereobench/configs/v3-own-reference.json",
                             "reduced": [], "why": "a configuration added by files alone"})
    bench["workloads"].append({"name": "v3-own-tiny", "config": "v3-own-reference",
                               "traffic": "tiny-new", "chips": 1,
                               "why": "a cell of a configuration added by files alone"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    sb = tmp_path / "stereobench"
    v3 = json.loads((sb / "configs" / "mobilestereonet-v3.json").read_text())
    (sb / "configs" / "v3-own-reference.json").write_text(json.dumps(
        dict(v3, name="v3-own-reference",
             reference="stereobench/reference/own_v3.py")))
    (sb / "reference" / "own_v3.py").write_text(
        (sb / "reference" / "mobilestereonet.py").read_text() + _COUNTED_BUILD)
    (sb / "workloads" / "v3-own-tiny.json").write_text(json.dumps(
        {"limits": {"worst_pair_epe_px": 4.0}}))
    (sb / "traffic" / "tiny-new.json").write_text(json.dumps({
        "loop": "camera", "rigs": 2, "height": 32, "width": 64,
        "rate_hz": 20, "pool_per_rig": 2, "max_disp_px": 24,
        "check_triggers": 2}))
    (sb / "workloads" / "v2-tiny-new.json").write_text(json.dumps(
        {"limits": {"worst_pair_epe_px": 5.0}}))
    (sb / "metrics" / "answered_share.new.py").write_text(
        "def read(window):\n"
        "    return 100.0 * window.units / window.attempted\n")
    return tmp_path


def test_new_files_are_found_by_name(checkout):
    before = {p.name: p.read_bytes() for p in (ROOT / "stereobench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    torch.set_num_threads(2)
    cell, metrics = run.load_cell("v2-tiny-new", seed=2**31 + 3, seconds=0.5,
                                  trace=True, device="cpu",
                                  t0=time.perf_counter(), root=checkout)
    assert cell.traffic["height"] == 32 and cell.limits["worst_pair_epe_px"] == 5.0
    assert [m["name"] for m in metrics] == ["answered_share.new"]
    cell.trace = False  # the CPU has no device trace
    result = run.run_cell(cell, metrics, root=checkout)
    assert result["correct"] is True
    assert result["metrics"] == {"answered_share.new": {"value": 100.0, "unit": "%"}}
    assert list(result)[-1] == "checks"
    after = {p.name: p.read_bytes() for p in (ROOT / "stereobench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after


def _snapshot():
    return {p.relative_to(ROOT): p.read_bytes()
            for p in (ROOT / "stereobench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_configuration_with_its_own_reference_is_found_by_name(checkout):
    before = _snapshot()
    torch.set_num_threads(2)
    cell, metrics = run.load_cell("v3-own-tiny", seed=2**31 + 5, seconds=0.5,
                                  trace=False, device="cpu",
                                  t0=time.perf_counter(), root=checkout)
    assert cell.config["name"] == "v3-own-reference"
    assert cell.reference.__file__ == str(checkout / "stereobench" / "reference"
                                          / "own_v3.py")
    result = run.run_cell(cell, metrics, root=checkout)
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["worst_pair_epe_px"]["value"] > 0
    # the weights, the check and the work counted all came from it
    assert cell.reference.BUILDS.count("meta") == 2
    assert cell.reference.BUILDS.count("cpu") == 2
    assert _snapshot() == before


@pytest.mark.parametrize("reference", [
    None, "stereobench/reference/absent.py", "stereobench/configs",
    "stereobench/reference/__init__.py", 7])
def test_a_configuration_whose_reference_is_missing_fails_set_up(checkout,
                                                                 reference):
    """No key, a file that is not there, a directory, a module with no
    ``build``, a value that is no path: each fails naming the key."""
    path = checkout / "stereobench" / "configs" / "v3-own-reference.json"
    cfg = json.loads(path.read_text())
    if reference is None:
        del cfg["reference"]
    else:
        cfg["reference"] = reference
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="key 'reference'"):
        run.load_cell("v3-own-tiny", seed=1, seconds=0.5, trace=False,
                      device="cpu", t0=time.perf_counter(), root=checkout)


@pytest.mark.parametrize("workload", ["v2-720p-rigs4", "v3-720p-cam1"])
def test_end_to_end_metrics_of_a_small_cpu_run(workload):
    """The cell as committed, but at 32 x 64 with a pool of 2."""
    torch.set_num_threads(2)
    cell, metrics = run.load_cell(workload, seed=7, seconds=0.5, trace=False,
                                  device="cpu", t0=time.perf_counter())
    assert {m["name"] for m in metrics} == {"frame_p95_ms", "frame_p50_ms",
                                            "setup_s"}
    cell.traffic.update(height=32, width=64, rate_hz=20, pool_per_rig=2,
                        max_disp_px=24, check_triggers=2)
    result = run.run_cell(cell, metrics)
    assert result["correct"] is True
    assert result["attempted"] == 10 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in metrics}
    assert result["metrics"]["setup_s"]["value"] > 0
    assert (result["metrics"]["frame_p95_ms"]["value"]
            >= result["metrics"]["frame_p50_ms"]["value"] > 0)


def test_end_to_end_metrics_of_a_small_cpu_training_run():
    """The training cell as committed, but batch 4 of 32 x 48 crops from 12
    scenes."""
    torch.set_num_threads(2)
    cell, metrics = run.load_cell("v2-train-b32", seed=7, seconds=0.5,
                                  trace=False, device="cpu",
                                  t0=time.perf_counter())
    assert {m["name"] for m in metrics} == {"train_pairs_per_s", "setup_s"}
    cell.traffic.update(batch_size=4, scenes=12, scene_hw=[40, 56],
                        max_disp_px=12)
    cell.traffic["data"] = dict(cell.traffic["data"], image_size=[32, 48])
    result = run.run_cell(cell, metrics)
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert result["metrics"]["train_pairs_per_s"]["value"] > 0
    assert set(result["checks"]) == set(cell.limits) | {"nonfinite_window_losses"}
    assert result["checks"]["nonfinite_window_losses"]["value"] == 0
