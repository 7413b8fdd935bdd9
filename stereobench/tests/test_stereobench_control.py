"""The check's control, the reference with float8 operands in the program's
place, at sizes a test run holds.  On the card, at the cells' own sizes,
``python3 -m stereobench.calibrate --kind control`` reads it (PERF.md)."""

import time

import pytest
import torch

from stereobench import calibrate, run


def _numbers(workload, kind, seed):
    torch.set_num_threads(2)
    cell, _ = run.load_cell(workload, seed=seed, seconds=0.5, trace=False,
                            device="cpu", t0=time.perf_counter())
    if cell.traffic["loop"] == "camera":
        cell.traffic.update(height=48, width=96, rate_hz=20, pool_per_rig=3,
                            max_disp_px=32, check_triggers=4)
    else:
        cell.traffic.update(batch_size=4, scenes=12, scene_hw=[40, 56],
                            max_disp_px=12)
        cell.traffic["data"] = dict(cell.traffic["data"], image_size=[32, 48])
    program = calibrate.KINDS[cell.traffic["loop"]][kind]
    return calibrate.reading(cell, program, 0.5)


@pytest.mark.parametrize("seed", [11, 12, 2**31 + 13])
@pytest.mark.parametrize("workload", ["v2-720p-rigs4", "v3-720p-cam1"])
def test_the_control_reads_far_from_the_reference(workload, seed):
    program = _numbers(workload, "program", seed)["worst_pair_epe_px"]
    control = _numbers(workload, "control", seed)["worst_pair_epe_px"]
    assert control >= 3 * program


@pytest.mark.parametrize("seed", [11, 2**31 + 13])
def test_the_training_control_fails_the_loss_limit(seed):
    cell, _ = run.load_cell("v2-train-b32", seed=seed, seconds=0.5,
                            trace=False, device="cpu", t0=time.perf_counter())
    limit = cell.limits["loss_rel_gap"]
    assert _numbers("v2-train-b32", "program", seed)["loss_rel_gap"] <= limit
    assert _numbers("v2-train-b32", "control", seed)["loss_rel_gap"] > limit
