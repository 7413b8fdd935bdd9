"""Optimizer and learning-rate schedule (port of
``realtime_stereo_matcher_tpu/train/optim.py``; reference train_stereo.py:30-48).

The JAX package's optax chain, step for step:

1. clip the gradients at global norm ``clip_norm`` in optax's form: unchanged
   below the limit, else scaled by ``clip_norm / norm``.  torch's
   ``clip_grad_norm_`` divides by ``norm + 1e-6`` instead; the port does not
   use it.
2. AdamW (beta 0.9/0.999, eps 1e-8, decoupled weight decay scaled by the
   learning rate, as ``optax.adamw``): ``torch.optim.AdamW``.
3. the OneCycle schedule of ``optax.linear_onecycle_schedule`` with the
   reference's arguments, as the port's own function of the step behind a
   ``LambdaLR``.  ``torch.optim.lr_scheduler.OneCycleLR`` is not used: its
   phase boundaries sit one step off optax's.  optax evaluates the schedule
   at the count before the update, so the scheduler steps after the
   optimizer.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def piecewise_linear_schedule(init_value: float,
                              boundaries_and_scales: dict) -> Callable:
    """optax ``piecewise_interpolate_schedule("linear", ...)``: the value is
    multiplied by each scale at its boundary, and interpolated linearly in
    between; constant after the last boundary."""
    bounds = [0]
    values = [float(init_value)]
    for b, scale in sorted(boundaries_and_scales.items()):
        bounds.append(int(b))
        values.append(values[-1] * float(scale))

    def schedule(count: int) -> float:
        for lo, hi, v0, v1 in zip(bounds, bounds[1:], values, values[1:]):
            if lo <= count < hi:
                return v0 + (v1 - v0) * (count - lo) / (hi - lo)
        return values[-1] if count >= bounds[-1] else 0.0

    return schedule


def linear_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, pct_final: float = 0.85,
                             div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Callable:
    """``optax.linear_onecycle_schedule``, boundaries and all (where two
    boundaries coincide the later scale wins, as in optax's dict)."""
    if transition_steps <= 0:
        raise ValueError("a linear onecycle schedule needs transition_steps > 0")
    return piecewise_linear_schedule(peak_value / div_factor, {
        int(pct_start * transition_steps): div_factor,
        int(pct_final * transition_steps): 1.0 / div_factor,
        transition_steps: 1.0 / final_div_factor,
    })


def onecycle_schedule(learn_rate: float, num_steps: int) -> Callable:
    """The reference OneCycleLR(total_steps + 100, pct_start 0.01, linear)
    in optax's form (the JAX package's ``onecycle_schedule``)."""
    return linear_onecycle_schedule(
        num_steps + 100, learn_rate, pct_start=0.01, pct_final=1.0,
        div_factor=25.0,
        # torch's final lr is (peak / div_factor) / final_div_factor; optax
        # divides the peak, so div_factor is folded in
        final_div_factor=25.0 * 1e4)


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place; returns the norm before clipping (a device tensor, no sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor.to(grads[0].dtype))
    return norm


class Optimizer:
    """clip, AdamW, schedule: one object with the optax chain's behaviour.

    ``step()`` clips the gradients, takes the AdamW step at the schedule's
    value for the current count, and advances the count.  ``state_dict()``
    holds the AdamW moments and the count."""

    def __init__(self, params, schedule: Callable, *, learn_rate: float,
                 weight_decay: float, clip_norm: float = 1.0):
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = clip_norm
        self.adamw = torch.optim.AdamW(self.params, lr=learn_rate,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lambda count: schedule(count) / learn_rate)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the gradient
        norm before clipping."""
        norm = clip_by_global_norm_(self.params, self.clip_norm)
        self.adamw.step()
        self.scheduler.step()
        return norm

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["scheduler"])


def make_optimizer(params, learn_rate: float, num_steps: int,
                   weight_decay: float, *, clip_norm: float = 1.0):
    """Returns (optimizer, schedule fn), as the JAX package's
    ``make_optimizer`` returns (optax chain, schedule)."""
    schedule = onecycle_schedule(learn_rate, num_steps)
    return Optimizer(params, schedule, learn_rate=learn_rate,
                     weight_decay=weight_decay, clip_norm=clip_norm), schedule
