"""Training steps in a closed loop, dispatched ahead as the port's
``train()`` runs them.

The traffic file gives ``batch_size``, ``scenes`` (resident on the card),
``scene_hw``, ``max_disp_px`` (the scenes' disparity range), ``train``
(``learn_rate``, ``weight_decay``, ``num_of_steps``, ``loss``: the config's
train section) and ``data`` (``image_size``, ``spatial_scale``,
``do_flip``, ``no_y_jitter``: its data section).  Step k takes batch k of a
per-epoch permutation of the scenes drawn from the seed: the port's
resident fetch (``data/device_cache.fetch_scene_batch``), its augmentation
on the card keyed by k (``data/device_augment.make_device_augment``), and
the step the port's trainer would take, in the configuration's ``dtype``
(SequenceLoss, clip + AdamW + OneCycle; :class:`PortTrainer`).  No step
waits for the card; the window ends with one synchronise.

Set-up drives the step through its first three steps, on rows that all
differ, and hands the same object to the window.  The check follows those
three steps with the configuration's plain float32 reference (the module
its ``reference`` key names) from the same weights and scenes: the
augmented batches, each step's loss, the first gradient as the optimizer
got it (AdamW's first moment after one step over 1 - beta1) and the change
of every parameter and BatchNorm statistic after three steps.  A step of
the window whose loss, read once the window has closed, is not finite
counts as failed.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import numpy as np
import torch

from stereobench import scenes, trace, weights, yardstick
from stereobench.loops.camera import Phases, config_dtype
from stereobench.reference import training as ref_train
from stereobench.reference.rounding import (
    float32_exact,
    round_fp8,
    set_operand_rounding,
)

CHECK_STEPS = 3
PROFILED_STEPS = 4   # steps of the traced sub-window
BETA1 = 0.9


def aug_params(data: dict) -> dict:
    """The augmentor's arguments from a config's data section (the port's
    ``config.aug_params``)."""
    return {"crop_size": tuple(data["image_size"]),
            "min_scale": data["spatial_scale"][0],
            "max_scale": data["spatial_scale"][1],
            "do_flip": data.get("do_flip", False),
            "yjitter": not data.get("no_y_jitter", False)}


def _float_state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()
            if v.is_floating_point()}


class PortTrainer:
    """The system under test: the port's resident fetch, augmentation and
    step on one model and optimizer.  The step is the one the port's
    trainer (``train/trainer.train``) takes: the kernel path
    (``models/fast_train.make_fast_train_step``) where
    ``fast_step_supported`` holds for the model and the traffic's crop, else
    the plain step (``train/trainer.make_train_step``), in the
    configuration's dtype."""

    def __init__(self, cell, state_dict, scene_data):
        from realtime_stereo_matcher_tpu_torch.config import load_config
        from realtime_stereo_matcher_tpu_torch.data.device_augment import (
            AugmentSpec,
            make_device_augment,
        )
        from realtime_stereo_matcher_tpu_torch.data.device_cache import (
            fetch_scene_batch,
        )
        from realtime_stereo_matcher_tpu_torch.models import build_model
        from realtime_stereo_matcher_tpu_torch.models.fast_train import (
            fast_step_supported,
            make_fast_train_step,
        )
        from realtime_stereo_matcher_tpu_torch.train.optim import make_optimizer
        from realtime_stereo_matcher_tpu_torch.train.trainer import (
            TrainState,
            make_train_step,
        )

        traffic = cell.traffic
        tcfg = traffic["train"]
        self.model = build_model(cell.config["model"], device=cell.device)
        self.model.load_state_dict(state_dict)
        self.model.train()
        self.tx, _ = make_optimizer(self.model.parameters(), tcfg["learn_rate"],
                                    tcfg["num_of_steps"], tcfg["weight_decay"])
        self.state = TrainState(self.model, self.tx)
        exp_config = load_config({
            "model": cell.config["model"], "data": traffic["data"],
            "train": dict(tcfg, batch_size=traffic["batch_size"])})
        make_step = (make_fast_train_step
                     if fast_step_supported(self.model, exp_config)
                     else make_train_step)
        self.step_fn = make_step(self.model, self.tx,
                                 tcfg["loss"]["parameters"],
                                 tcfg["loss"]["type"],
                                 dtype=config_dtype(cell.config))
        left, right, disp = scene_data
        # the resident pack's layout: uint8 views, the disparity as 16-bit
        # fixed-point words held as int16 bit patterns
        q = torch.round(disp * 512.0).clamp(0, 65534).to(torch.int32)
        self.arrays = (left, right, torch.where(q >= 32768, q - 65536, q)
                       .to(torch.int16))
        self.fetch = lambda idx: fetch_scene_batch(self.arrays, idx, 512.0)
        self.augment = make_device_augment(AugmentSpec.from_aug_params(
            aug_params(traffic["data"]), tuple(left.shape[1:3])))

    def step(self, k: int, idx):
        """Step ``k`` on scenes ``idx``; returns (augmented batch, loss)."""
        with torch.profiler.record_function("bench.fetch and augment"):
            batch = self.augment(k, *self.fetch(idx))
        with torch.profiler.record_function("bench.step"):
            self.state, metrics = self.step_fn(self.state, *batch)
        return batch, metrics["live_loss"]

    def float_state(self) -> dict:
        return _float_state(self.model)

    def first_gradient(self) -> dict:
        """The gradient the optimizer got in its first step, from its state:
        AdamW's first moment over 1 - beta1."""
        return {n: self.tx.adamw.state[p]["exp_avg"] / (1.0 - BETA1)
                for n, p in self.model.named_parameters()}


class ReferenceTrainer:
    """The configuration's reference's step (float32, TF32 off) as a
    program; with ``rounding``, every convolution's operands rounded first
    (the check's control)."""

    def __init__(self, cell, state_dict, scene_data, rounding=None):
        traffic = cell.traffic
        tcfg = traffic["train"]
        self.model = cell.reference.build(cell.config["model"], cell.device)
        self.model.load_state_dict(state_dict)
        self.model.train()
        set_operand_rounding(self.model, rounding)
        self.update = ref_train.Update(self.model.parameters(),
                                       learn_rate=tcfg["learn_rate"],
                                       weight_decay=tcfg["weight_decay"],
                                       num_steps=tcfg["num_of_steps"])
        self.loss_params = tcfg["loss"]["parameters"]
        self.scenes = scene_data
        self.spec = ref_train.AugmentSpec.from_aug_params(
            aug_params(traffic["data"]), tuple(scene_data[0].shape[1:3]))

    def batch(self, k: int, idx):
        left, right, disp = self.scenes
        return ref_train.augment(self.spec, k, left[idx], right[idx],
                                 ref_train.fixed_point_flow(disp[idx]))

    def step(self, k: int, idx):
        batch = self.batch(k, idx)
        img1, img2, flow, valid = batch
        with float32_exact():
            self.update.adamw.zero_grad(set_to_none=True)
            loss = ref_train.sequence_loss(self.model(img1, img2), flow, valid,
                                           **self.loss_params)
            loss.backward()
            self.update.step()
        return batch, loss.detach()

    def float_state(self) -> dict:
        return _float_state(self.model)

    def first_gradient(self) -> dict:
        return {n: self.update.adamw.state[p]["exp_avg"] / (1.0 - BETA1)
                for n, p in self.model.named_parameters()}


def port_program(*args):
    return PortTrainer(*args)


def control_program(*args):
    return ReferenceTrainer(*args, rounding=round_fp8)


def index_table(seed: int, n_scenes: int, batch: int, steps: int, device):
    """(steps, batch) scene indices: consecutive batches of per-epoch
    permutations drawn from the seed, so the first epoch's batches share
    no scene."""
    rng = np.random.default_rng(seed)
    per_epoch = n_scenes // batch
    epochs = -(-steps // per_epoch)
    rows = [rng.permutation(n_scenes)[:per_epoch * batch].reshape(per_epoch, batch)
            for _ in range(epochs)]
    return torch.from_numpy(np.concatenate(rows)[:steps]).to(device)


@dataclasses.dataclass
class Window:
    window_s: float
    attempted: int
    failed: int
    units: int                # steps completed in the window
    pairs_per_unit: int
    host_s: list              # each untraced step's fetch + augment + step call
    flops_per_unit: float
    conv_least_s_per_unit: float
    memory_peak_bytes: int
    checks: dict
    trace: trace.Trace | None = None
    setup_s: float = 0.0


@dataclasses.dataclass
class Followed:
    """What the check takes from the first steps of a trainer."""

    batches: list
    losses: list
    first_gradient: dict
    before: dict
    after: dict


def follow(trainer, idx_table) -> Followed:
    """Run the first :data:`CHECK_STEPS` steps of ``trainer`` and keep what
    the check compares."""
    before = trainer.float_state()
    batches, losses, first = [], [], None
    for k in range(CHECK_STEPS):
        batch, loss = trainer.step(k, idx_table[k])
        batches.append([t.detach().clone() for t in batch])
        losses.append(loss.detach().clone())
        if k == 0:
            first = {n: g.detach().clone() for n, g in trainer.first_gradient().items()}
    return Followed(batches, losses, first, before, trainer.float_state())


def _norm_gaps(prog: dict, ref: dict, keep) -> dict:
    """Each leaf's |‖prog‖ - ‖ref‖| over the larger of ‖ref‖ and the median
    leaf's ‖ref‖, over the leaves ``keep`` names (a non-finite norm reads
    as infinite)."""
    names = [n for n in ref if keep(n)]
    ref_n = {n: float(torch.linalg.vector_norm(ref[n].float())) for n in names}
    med = float(np.median(list(ref_n.values())))
    gaps = {}
    for n in names:
        p = float(torch.linalg.vector_norm(prog[n].float()))
        gaps[n] = (abs(p - ref_n[n]) / max(ref_n[n], med) if math.isfinite(p)
                   else math.inf)
    return gaps


def compare(prog: Followed, ref: Followed) -> dict:
    """The numbers the check can compare (each 0 where the two agree):
    ``augment_max_abs`` the augmented batches' largest gap (levels, px);
    ``loss_rel_gap`` the steps' losses (``first_loss_rel_gap`` the first
    step's); ``grad_norm_gap`` the first gradient and ``change_norm_gap``
    the change after the steps, worst leaf (``..._median_leaf``: the median
    leaf's gap; ``..._worst_leaf``: which leaf).  A parameter whose reference gradient is below a thousandth of
    the median leaf's moves by round-off alone and is left out of both."""
    aug = max(float((a.float() - b.float()).abs().max())
              for pb, rb in zip(prog.batches, ref.batches) for a, b in zip(pb, rb))
    loss = max(abs(float(lp) - float(lr)) / max(abs(float(lr)), 1e-12)
               for lp, lr in zip(prog.losses, ref.losses))
    g_norm = {n: float(torch.linalg.vector_norm(g)) for n, g in ref.first_gradient.items()}
    med = float(np.median(list(g_norm.values())))
    moving = {n for n, v in g_norm.items() if v >= 1e-3 * med}
    keep = lambda n: n in moving or n.endswith(("running_mean", "running_var"))
    change_p = {n: prog.after[n] - prog.before[n] for n in prog.after}
    change_r = {n: ref.after[n] - ref.before[n] for n in ref.after}
    grad = _norm_gaps(prog.first_gradient, ref.first_gradient, lambda n: n in moving)
    change = _norm_gaps(change_p, change_r, keep)
    out = {"augment_max_abs": aug, "loss_rel_gap": loss,
           "first_loss_rel_gap": abs(float(prog.losses[0]) - float(ref.losses[0]))
           / max(abs(float(ref.losses[0])), 1e-12)}
    for name, gaps in (("grad", grad), ("change", change)):
        worst = max(gaps, key=gaps.get)
        out[f"{name}_norm_gap"] = gaps[worst]
        out[f"{name}_norm_gap_median_leaf"] = float(np.median(list(gaps.values())))
        out[f"{name}_worst_leaf"] = worst
    out["left_out_leaves"] = sorted(set(g_norm) - moving)
    return out


def prepare(cell, program=port_program):
    """Weights, resident scenes, the trainer, and its first steps."""
    t = cell.traffic
    dev, seed = cell.device, cell.seed
    phases = Phases(dev)
    model_cfg = cell.config["model"]
    sd = weights.seeded_state_dict(cell.reference.build(model_cfg, "meta"),
                                   seed, dev)
    phases("weights")
    h, w = t["scene_hw"]
    scene_data = scenes.make_scenes(t["scenes"], h, w, max_disp=t["max_disp_px"],
                                    seed=seed + 1, device=dev)
    phases("scenes")
    trainer = program(cell, sd, scene_data)
    phases("program built")
    followed = follow(trainer, index_table(seed, t["scenes"], t["batch_size"],
                                           CHECK_STEPS, dev))
    phases("first steps")
    print("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.seconds),
          file=sys.stderr, flush=True)
    return trainer, sd, scene_data, followed


def reference_readings(cell, sd, scene_data, followed: Followed) -> dict:
    """The reference's first steps from the same weights and scenes, and
    the numbers :func:`compare` gives."""
    t = cell.traffic
    ref = ReferenceTrainer(cell, sd, scene_data)
    ref_followed = follow(ref, index_table(cell.seed, t["scenes"], t["batch_size"],
                                           CHECK_STEPS, cell.device))
    return compare(followed, ref_followed)


def run(cell, program=port_program) -> Window:
    """One run: set-up (with the first steps), steps for ``cell.seconds``
    with no synchronise until the end, then the check."""
    t = cell.traffic
    dev = cell.device
    cuda = dev.type == "cuda"
    trainer, sd, scene_data, followed = prepare(cell, program)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        if cell.trace:
            trace.warm_up()
    table = index_table(cell.seed, t["scenes"], t["batch_size"], 100_000, dev)
    k, host, losses, prof = CHECK_STEPS, [], [], None
    traced_at = None
    gc.collect()
    gc.disable()
    t_start = time.perf_counter()
    setup_s = t_start - cell.t0
    while time.perf_counter() - t_start < cell.seconds:
        if cell.trace and traced_at is None and time.perf_counter() - t_start > cell.seconds / 2:
            traced_at = k
            prof = torch.profiler.profile(activities=trace.ACTIVITIES)
            prof.start()
            sync()
            with torch.profiler.record_function("bench.window"):
                for _ in range(PROFILED_STEPS):
                    losses.append(trainer.step(k, table[k])[1])
                    k += 1
                sync()
            prof.stop()
            continue
        t_call = time.perf_counter()
        losses.append(trainer.step(k, table[k])[1])
        host.append(time.perf_counter() - t_call)
        k += 1
    sync()
    window_s = time.perf_counter() - t_start
    gc.enable()
    steps = k - CHECK_STEPS
    # a step of the window whose loss is not finite has failed
    nonfinite = int((~torch.isfinite(torch.stack(losses).float())).sum())
    del losses
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    tr = (trace.reduce(prof, window_span="bench.window", units=PROFILED_STEPS)
          if prof is not None else None)

    del trainer
    if cuda:
        torch.cuda.empty_cache()
    numbers = reference_readings(cell, sd, scene_data, followed)
    checks = {name: {"value": numbers[name], "limit": limit,
                     "ok": numbers[name] <= limit}
              for name, limit in cell.limits.items()}
    checks["nonfinite_window_losses"] = {"value": nonfinite, "limit": 0,
                                         "ok": nonfinite == 0}

    # the work of a step, counted on the reference on the meta device
    meta_ref = cell.reference.build(cell.config["model"], "meta").train()
    ch, cw = t["data"]["image_size"]
    shape = torch.empty((t["batch_size"], ch, cw, 3), device="meta")
    _, conv_least = yardstick.conv_work(meta_ref, (shape, shape), backward=True)
    flops = yardstick.model_flops_train(meta_ref, (shape, shape))
    return Window(window_s=window_s, attempted=steps, failed=nonfinite,
                  units=steps,
                  pairs_per_unit=t["batch_size"], host_s=host,
                  flops_per_unit=flops, conv_least_s_per_unit=conv_least,
                  memory_peak_bytes=peak, checks=checks, trace=tr,
                  setup_s=setup_s)
