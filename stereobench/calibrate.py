"""Readings that a cell's correctness limits are set from (not run by the
benchmark's own runs).

    python3 -m stereobench.calibrate --workload <name> --kind program --seeds 1 2 3 ... [--seconds 2]

``--kind`` names what runs in the program's place:

* ``program``: the port, as a run drives it (the lower readings);
* ``control``: the configuration's plain reference with every
  convolution's operands rounded to float8 e4m3, the precision below the
  configuration's bfloat16 (the upper readings);
* a training cell's faults, planted in the port: ``half_batch`` (the step
  takes half the batch, its mean over the rest), ``stale_augment`` (the
  augmentation keyed by the next step: an answer altered where it is
  produced) and ``unchanged`` (the step returns the parameters as they
  were).

Each seed sets the cell up as a run does and reads the numbers the run
compares: a camera cell after a short open loop at its own rate, of as
many triggers as a run keeps; a training cell after its first steps.  One
JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from stereobench import isolation
from stereobench.loops import camera, train
from stereobench.reference.rounding import round_fp8
from stereobench.run import load_cell


def camera_control(cell, state_dict):
    return camera.reference_program(cell, state_dict, rounding=round_fp8)


class HalfBatch(train.PortTrainer):
    def step(self, k, idx):
        batch = self.augment(k, *self.fetch(idx))
        half = [t[: t.shape[0] // 2] for t in batch]
        self.state, metrics = self.step_fn(self.state, *half)
        return batch, metrics["live_loss"]


class StaleAugment(train.PortTrainer):
    def step(self, k, idx):
        return super().step(k + 1, idx)


class Unchanged(train.PortTrainer):
    @torch.no_grad()
    def _restore(self, saved):
        for name, t in self.model.state_dict().items():
            t.copy_(saved[name])

    def step(self, k, idx):
        saved = {n: t.clone() for n, t in self.model.state_dict().items()}
        batch, loss = super().step(k, idx)
        self._restore(saved)
        return batch, loss


KINDS = {
    "camera": {"program": camera.port_program, "control": camera_control},
    "train": {"program": train.port_program, "control": train.control_program,
              "half_batch": HalfBatch, "stale_augment": StaleAugment,
              "unchanged": Unchanged},
}


def reading(cell, program, seconds: float) -> dict:
    """The numbers a run of ``cell`` compares, with ``program`` in the
    port's place."""
    if cell.traffic["loop"] == "camera":
        t = cell.traffic
        rate = float(t["rate_hz"])
        p = camera.prepare(cell, program)
        n_due = max(1, math.floor(seconds * rate))
        loop = camera.open_loop(p, cell.device, rate_hz=rate, seconds=seconds,
                                keep=camera.check_indices(cell.seed, n_due,
                                                          t["check_triggers"]))
        p.forward = None
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
        return camera.check_errors(cell, p, loop.kept)
    trainer, sd, scene_data, followed = train.prepare(cell, program)
    del trainer
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return train.reference_readings(cell, sd, scene_data, followed)


def main(argv=None) -> int:
    isolation.block()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", default="program")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        cell, _ = load_cell(args.workload, seed=seed, seconds=args.seconds,
                            trace=False, device="cuda:0", t0=time.perf_counter())
        program = KINDS[cell.traffic["loop"]][args.kind]
        numbers = reading(cell, program, args.seconds)
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, **numbers,
                          "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
