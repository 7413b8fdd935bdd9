"""Config-driven training loop (port of
``realtime_stereo_matcher_tpu/train/trainer.py``; reference
train_stereo.py:138-212).

As in the JAX package:

* bf16 compute with float32 parameters (no loss scaling);
* the kernel train path (``models/fast_train.py``) under
  ``train.fast_kernels`` "auto" / "on" / "off"; "on" raises where the path
  does not apply;
* checkpoints carry the full train state (weights, BatchNorm stats,
  optimizer moments, schedule count and step), and a restore wins over the
  train-start init.

PyTorch runs eagerly and updates in place: the state is the model (weights
and running stats), the optimizer and the step count, and a step mutates
them.  The plain step runs the model under ``torch.autocast`` for bf16.
Not ported yet (ROADMAP.md): the dataset pipeline (pass ``data_loader``),
freeze_bn, the device-resident cache and augment, the metric logger, and
data parallelism.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path

import torch

from realtime_stereo_matcher_tpu_torch import resolve_device
from realtime_stereo_matcher_tpu_torch.config import ExperimentConfig, TrainConfig
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.fast_train import (
    fast_step_supported,
    make_fast_train_step,
)
from realtime_stereo_matcher_tpu_torch.train.init import reference_initialize
from realtime_stereo_matcher_tpu_torch.train.loss import (
    build_loss_function,
    flow_map_metrics,
)
from realtime_stereo_matcher_tpu_torch.train.optim import Optimizer, make_optimizer


@dataclasses.dataclass
class TrainState:
    """The model (weights and running stats), its optimizer, and the number
    of steps taken."""

    model: torch.nn.Module
    tx: Optimizer
    step: int = 0


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def create_train_state(exp_config: ExperimentConfig, *, seed: int = 1234,
                       device="cuda"):
    """Build the model with the reference train-start init (drawn from
    ``seed``) and its optimizer; returns (model, tx, schedule, state)."""
    gen = torch.Generator().manual_seed(seed)
    model = build_model(exp_config.model.as_dict(), device=device,
                        generator=gen)
    reference_initialize(model, gen)
    model.train()
    tcfg = exp_config.train or TrainConfig()
    tx, schedule = make_optimizer(model.parameters(), tcfg.learn_rate,
                                  tcfg.num_of_steps, tcfg.weight_decay)
    return model, tx, schedule, TrainState(model, tx)


def make_train_step(model, tx, loss_params: dict,
                    loss_type: str = "SequenceLoss", *, dtype=torch.float32):
    """Plain ``(state, img1, img2, flow, valid) -> (state, metrics)`` step:
    the model's own forward in train mode (autocast to ``dtype``), the loss
    in float32, then clip + AdamW + schedule.  Updates state in place."""
    loss = build_loss_function({"type": loss_type, "parameters": loss_params})

    def train_step(state, img1, img2, flow, valid):
        model.train()
        tx.zero_grad()
        with torch.autocast(img1.device.type, dtype=dtype,
                            enabled=dtype != torch.float32):
            preds = model(img1, img2)
        loss_val = loss(preds, flow, valid)
        loss_val.backward()
        tx.step()
        metrics = flow_map_metrics(flow, preds[-1].detach(), valid)
        metrics["live_loss"] = loss_val.detach()
        state.step += 1
        return state, metrics

    return train_step


def save_checkpoint(path, state: TrainState) -> None:
    """Save the full train state with ``torch.save``."""
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "tx": state.tx.state_dict()}, path)


def restore_checkpoint(path, state: TrainState) -> TrainState:
    """Load a :func:`save_checkpoint` file into ``state`` (in place)."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.tx.load_state_dict(ckpt["tx"])
    state.step = int(ckpt["step"])
    return state


def train(exp_config: ExperimentConfig, *, max_steps: int | None = None,
          data_loader=None, device="cuda", use_bf16: bool | None = None,
          on_step=None) -> str:
    """Run training per config; returns the final checkpoint path.

    ``data_loader`` is re-iterated pass after pass and yields
    ``(names, img1, img2, flow, valid)`` batches.  Like the reference loop,
    the stop check follows the step, so ``max_steps = n`` takes n + 1 steps.
    ``on_step(step, metrics)`` is called after every step with the step's
    metric tensors (nothing is synchronised).  Checkpoints go to
    ``<exp_config.path>/checkpoints``."""
    if use_bf16 is None:
        use_bf16 = exp_config.model.mixed_precision
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    dev = resolve_device(device)
    tcfg = exp_config.train
    num_steps = max_steps or tcfg.num_of_steps
    if data_loader is None:
        raise NotImplementedError(
            "the port's dataset pipeline is queued in ROADMAP.md; pass "
            "data_loader")
    if tcfg.freeze_bn or tcfg.device_augment:
        raise NotImplementedError(
            "train.freeze_bn and train.device_augment are queued in ROADMAP.md")

    model, tx, _, state = create_train_state(exp_config, device=dev)
    logging.info("Model parameter count: %d.", count_parameters(model))
    if tcfg.restore_checkpoint:
        logging.info("Restoring full train state from %s...",
                     tcfg.restore_checkpoint)
        state = restore_checkpoint(tcfg.restore_checkpoint, state)

    loss_params, loss_type = tcfg.loss.parameters, tcfg.loss.type
    build_loss_function({"type": loss_type, "parameters": loss_params})
    fast_mode = tcfg.fast_kernels
    if fast_mode not in ("auto", "on", "off"):
        raise ValueError(f"train.fast_kernels must be auto, on or off, "
                         f"not {fast_mode!r}")
    use_fast = fast_mode != "off" and fast_step_supported(model, exp_config)
    if fast_mode == "on" and not use_fast:
        raise ValueError(
            "train.fast_kernels='on' but the kernel train path does not "
            "support this model/crop (see fast_step_supported)")
    make_step = make_fast_train_step if use_fast else make_train_step
    logging.info("Training on the %s path.", "kernel" if use_fast else "plain")
    step_fn = make_step(model, tx, loss_params, loss_type, dtype=dtype)

    ckpt_dir = Path(exp_config.path) / "checkpoints"
    total_steps = state.step
    t_start = time.time()
    while True:
        n_batches = 0
        for _, img1, img2, flow, valid in data_loader:
            n_batches += 1
            batch = (t.to(dev, non_blocking=True)
                     for t in (img1, img2, flow, valid))
            state, metrics = step_fn(state, *batch)
            if on_step is not None:
                on_step(total_steps, metrics)
            total_steps += 1
            if total_steps > num_steps:
                break
            if total_steps % tcfg.save_checkpoint_frequency == 0:
                ckpt = ckpt_dir / f"{exp_config.name}-epoch-{total_steps}.ckpt"
                ckpt.parent.mkdir(parents=True, exist_ok=True)
                logging.info("Saving file %s...", ckpt)
                save_checkpoint(ckpt, state)
        if not n_batches:
            raise ValueError("data_loader yielded no batch")
        if total_steps > num_steps:
            break
    logging.info("FINISHED TRAINING! (%.1fs)", time.time() - t_start)
    final = ckpt_dir / f"{exp_config.name}-epoch-{total_steps}.ckpt"
    final.parent.mkdir(parents=True, exist_ok=True)
    save_checkpoint(final, state)
    return str(final)
