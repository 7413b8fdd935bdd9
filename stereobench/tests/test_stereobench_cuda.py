"""Short runs of every cell through the command, on a card (``-m cuda``);
each decides inside the test whether a card exists."""

import json
import subprocess
import sys

import pytest
import torch

from stereobench.run import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card_is_correct(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "stereobench.run", "--workload",
                          workload, "--seed", str(2**31 + 99), "--seconds", "3",
                          "--trace", str(trace)], cwd=ROOT, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
