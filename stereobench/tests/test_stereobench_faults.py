"""The check fails a run whose timed path is broken underneath: each fault
a cell can have, planted where the answer is produced, on the CPU at a
small size with the cell's own limits (a camera cell: an answer altered, a
stale answer, half the rigs left out; a training cell: half the batch left
out, the augmentation keyed by another step, the state left unchanged)."""

import time

import pytest
import torch

from stereobench import calibrate, run
from stereobench.loops import camera, train


def _altered(cell, sd):
    forward = camera.port_program(cell, sd)

    def broken(left, right):
        out = forward(left, right)
        out[-1][0] *= -1.0  # one pair's finest map with the sign convention lost
        return out
    return broken


def _half_batch(cell, sd):
    forward = camera.port_program(cell, sd)

    def broken(left, right):
        half = max(1, left.shape[0] // 2)
        out = forward(left[:half], right[:half])
        reps = -(-left.shape[0] // half)
        return [torch.cat([o] * reps)[:left.shape[0]] for o in out]
    return broken


def _stale(cell, sd):
    forward = camera.port_program(cell, sd)
    last = []

    def broken(left, right):
        out = forward(left, right)
        answer = last[0] if last else out
        last[:] = [out]
        return answer
    return broken


def _result(workload, program, seed=2**31 + 21):
    torch.set_num_threads(2)
    cell, metrics = run.load_cell(workload, seed=seed, seconds=0.5, trace=False,
                                  device="cpu", t0=time.perf_counter())
    cell.traffic.update(height=48, width=96, rate_hz=20, pool_per_rig=3,
                        max_disp_px=32, check_triggers=4)
    return run.run_cell(cell, metrics, program=program)


@pytest.mark.parametrize("workload", ["v2-720p-rigs4", "v3-720p-cam1"])
def test_the_sound_program_passes(workload):
    assert _result(workload, camera.port_program)["correct"] is True


@pytest.mark.parametrize("fault", [_altered, _stale])
@pytest.mark.parametrize("workload", ["v2-720p-rigs4", "v3-720p-cam1"])
def test_a_fault_fails_the_check(workload, fault):
    result = _result(workload, fault)
    assert result["correct"] is False
    epe = result["checks"]["worst_pair_epe_px"]
    assert epe["value"] > epe["limit"]


def test_half_the_batch_left_out_fails_the_check():
    result = _result("v2-720p-rigs4", _half_batch)
    assert result["correct"] is False


def _train_result(program, seed=2**31 + 31):
    torch.set_num_threads(2)
    cell, metrics = run.load_cell("v2-train-b32", seed=seed, seconds=0.3,
                                  trace=False, device="cpu",
                                  t0=time.perf_counter())
    cell.traffic.update(batch_size=4, scenes=12, scene_hw=[40, 56],
                        max_disp_px=12)
    cell.traffic["data"] = dict(cell.traffic["data"], image_size=[32, 48])
    return run.run_cell(cell, metrics, program=program)


def test_the_sound_training_step_passes():
    assert _train_result(train.port_program)["correct"] is True


@pytest.mark.parametrize("kind", ["half_batch", "stale_augment", "unchanged"])
def test_a_training_fault_fails_the_check(kind):
    result = _train_result(calibrate.KINDS["train"][kind])
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


class _NonFiniteInTheWindow(train.PortTrainer):
    """A step of the window (past the checked first steps) whose loss is
    not finite."""

    def step(self, k, idx):
        batch, loss = super().step(k, idx)
        return batch, loss * float("nan") if k == train.CHECK_STEPS else loss


def test_a_nonfinite_loss_in_the_window_fails_the_run():
    result = _train_result(_NonFiniteInTheWindow)
    assert result["correct"] is False
    assert result["failed"] == 1
    assert result["checks"]["nonfinite_window_losses"]["value"] == 1
