"""Synchronised stereo cameras at a fixed trigger rate: an open loop.

The traffic file gives ``rigs`` (pairs a trigger), ``height``, ``width``,
``rate_hz``, ``pool_per_rig`` (distinct pairs a rig, cycled), ``max_disp_px``
(the scenes' disparity range) and ``check_triggers`` (how many of the
window's triggers the check compares).  Trigger k is due at ``k /
rate_hz`` seconds into the window and carries pair ``k % pool_per_rig`` of
every rig.  One trigger is in flight: the program answers it, the host
synchronises, and the next trigger goes out at its due time or, if that
has passed, at once.  A trigger's latency runs from its due time to the
end of that synchronise, so a late start counts.

The program is the port's own inference route,
``eval/validators.ModelRunner``, in the configuration's ``dtype``, on a
model of the configuration with the benchmark's seeded weights
(:func:`port_program`).  The check compares every disparity map the
program returns (coarse to fine) for ``check_triggers`` triggers drawn
from the seed, as the timed path produced them, with the configuration's
plain float32 reference (the module its ``reference`` key names) on the
same inputs and weights.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import random
import sys
import time

import torch

from stereobench import scenes, trace, weights, yardstick
from stereobench.reference.rounding import float32_exact, set_operand_rounding

PROFILED_SECONDS = 0.5  # length of the traced sub-window


def config_dtype(config: dict) -> torch.dtype:
    """The floating type the configuration file's ``dtype`` names."""
    dtype = getattr(torch, str(config.get("dtype")), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"the configuration's key 'dtype' has to name a "
                         f"torch floating type, not {config.get('dtype')!r}")
    return dtype


def port_program(cell, state_dict: dict):
    """The system under test: the route the port's evaluation runs a model
    on (``eval/validators.ModelRunner``, as ``evaluate.build_runner``
    builds it) in the configuration's dtype.  A model with a kernel path
    (v1, v2, v3) runs it: on a card the ``GraphPolicy`` of
    ``models/fast_infer.make_fast_forward``, on the CPU its kernels' plain
    versions.  Any other (V4, DispNetC) runs its plain forward, on a card
    under autocast to the dtype, on the CPU in float32."""
    from realtime_stereo_matcher_tpu_torch.eval.validators import ModelRunner
    from realtime_stereo_matcher_tpu_torch.models import build_model
    from realtime_stereo_matcher_tpu_torch.models.fast_infer import (
        has_kernel_path,
    )
    net = build_model(cell.config["model"], device=cell.device)
    net.load_state_dict(state_dict)
    return ModelRunner(net, fast=True if has_kernel_path(net) else "auto",
                       dtype=config_dtype(cell.config), device=cell.device)


def reference_program(cell, state_dict: dict, *, rounding=None):
    """The configuration's plain reference as a program: float32, TF32
    off, its convolutions' operands through ``rounding`` where one is given
    (the check's control: ``rounding.round_fp8``)."""
    ref = cell.reference.build(cell.config["model"], cell.device)
    ref.load_state_dict(state_dict)
    set_operand_rounding(ref, rounding)

    @torch.no_grad()
    def forward(left, right):
        with float32_exact():
            return ref(left, right)

    return forward


@dataclasses.dataclass
class Window:
    latencies_s: list
    host_s: list            # each untraced trigger's forward call, no sync
    service_s: list         # each untraced trigger's call to its synchronise
    window_s: float
    attempted: int
    failed: int
    units: int              # triggers completed
    flops_per_unit: float
    conv_least_s_per_unit: float
    memory_peak_bytes: int
    checks: dict            # name -> {"value", "limit", "ok"}
    trace: trace.Trace | None = None
    setup_s: float = 0.0


def check_indices(seed: int, n_due: int, k: int) -> list[int]:
    """The ``k`` triggers (of ``n_due``) whose answers the check compares,
    drawn from the seed; the window's last trigger is always one."""
    rng = random.Random(seed)
    picks = set(rng.sample(range(n_due - 1), min(k - 1, n_due - 1)))
    return sorted(picks | {n_due - 1})


def _wait_until(t: float) -> None:
    """Spin until ``t``.  A host core that sleeps between triggers wakes
    late and runs the next trigger's launches slower: on an H100 host,
    sleeping read a v3 trigger's median ~10% longer and its 95th percentile
    up to twice as long as spinning."""
    while time.perf_counter() < t:
        pass


def pair_errors(outs, refs) -> dict:
    """``worst_pair_epe_px``: the largest mean |program - reference| (px)
    over the maps (as many as the program returns) and pairs of one
    trigger; a non-finite output reads as infinite."""
    worst = 0.0
    for o, r in zip(outs, refs):
        if not bool(torch.isfinite(o).all()):
            return {"worst_pair_epe_px": math.inf}
        per_pair = (o.float() - r.float()).abs().flatten(1).mean(1)
        worst = max(worst, float(per_pair.max()))
    return {"worst_pair_epe_px": worst}


@dataclasses.dataclass
class Prepared:
    """A cell's program, inputs and weights after set-up."""

    forward: object
    left: torch.Tensor        # (pool, rigs, H, W, 3) uint8
    right: torch.Tensor
    state_dict: dict


def prepare(cell, program=port_program) -> Prepared:
    """Weights and inputs from the seed, the program built and warmed up on
    the cell's one shape."""
    t = cell.traffic
    dev, seed = cell.device, cell.seed
    model_cfg = cell.config["model"]
    rigs, h, w, pool = t["rigs"], t["height"], t["width"], t["pool_per_rig"]

    phases = Phases(dev)
    sd = weights.seeded_state_dict(cell.reference.build(model_cfg, "meta"),
                                   seed, dev)
    phases("weights")
    left, right = scenes.make_pairs(pool * rigs, h, w, max_disp=t["max_disp_px"],
                                    seed=seed + 1, device=dev)
    # batch j: pair j of every rig, contiguous
    left = left.view(rigs, pool, h, w, 3).transpose(0, 1).contiguous()
    right = right.view(rigs, pool, h, w, 3).transpose(0, 1).contiguous()
    phases("scenes")
    with float32_exact():
        sd = weights.calibrate_batchnorm(cell.reference.build(model_cfg, dev),
                                         sd, (left[0], right[0]))
    phases("batch-norm statistics")
    forward = program(cell, sd)
    phases("program built")
    for j in range(min(3, pool)):
        forward(left[j], right[j])
    phases("warm-up")
    print("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.seconds),
          file=sys.stderr, flush=True)
    return Prepared(forward, left, right, sd)


class Phases:
    """Seconds of each set-up phase, to the end of its device work."""

    def __init__(self, device):
        self.device, self.seconds = device, []
        self.at = time.perf_counter()

    def __call__(self, name):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds.append((name, now - self.at))
        self.at = now


@dataclasses.dataclass
class Loop:
    latencies_s: list
    host_s: list
    service_s: list
    kept: dict               # trigger -> the program's answer
    window_s: float
    due: int
    prof: object = None      # the stopped profiler of the traced triggers
    traced: int = 0


def open_loop(p: Prepared, device, *, rate_hz: float, seconds: float,
              keep=(), traced: int = 0) -> Loop:
    """Triggers at ``rate_hz`` for ``seconds``, one in flight; ``traced``
    triggers from the middle of the window run under the profiler, inside
    the span ``bench.window`` of exactly that many periods."""
    pool = p.left.shape[0]
    sync = ((lambda: torch.cuda.synchronize(device)) if device.type == "cuda"
            else (lambda: None))
    period = 1.0 / rate_hz
    n_due = max(1, math.floor(seconds * rate_hz))
    k0 = (n_due - traced) // 2 if traced else -1
    if traced and k0 < 1:
        raise ValueError("the window is too short to trace")
    keep = set(keep)
    kept, lat, host, service = {}, [], [], []
    prof = span = None
    gc.collect()
    gc.disable()  # no collector pause inside the window
    t_start = time.perf_counter()
    for k in range(n_due):
        due = t_start + k * period
        if k == k0:
            prof = torch.profiler.profile(activities=trace.ACTIVITIES)
            prof.start()
            _wait_until(due)
            span = torch.profiler.record_function("bench.window")
            span.__enter__()
        with torch.profiler.record_function("bench.wait for trigger"):
            _wait_until(due)
        with torch.profiler.record_function("bench.forward enqueue"):
            t_call = time.perf_counter()
            out = p.forward(p.left[k % pool], p.right[k % pool])
            t_ret = time.perf_counter()
        with torch.profiler.record_function("bench.synchronize"):
            sync()
        t_end = time.perf_counter()
        lat.append(t_end - due)
        if not (traced and k0 <= k < k0 + traced):
            host.append(t_ret - t_call)
            service.append(t_end - t_call)
        if k in keep:
            kept[k] = out
        if span is not None and k == k0 + traced - 1:
            with torch.profiler.record_function("bench.wait for trigger"):
                _wait_until(t_start + (k + 1) * period)
            span.__exit__(None, None, None)
            prof.stop()
            span = None
    window_s = time.perf_counter() - t_start
    gc.enable()
    return Loop(lat, host, service, kept, window_s, n_due, prof, traced)


def check_errors(cell, p: Prepared, kept: dict) -> dict:
    """:func:`pair_errors` of the kept answers against the reference, run
    here trigger by trigger, the worst over the triggers."""
    ref = reference_program(cell, p.state_dict)
    pool = p.left.shape[0]
    per = [pair_errors(kept[k], ref(p.left[k % pool], p.right[k % pool]))
           for k in sorted(kept)]
    return {name: max(e[name] for e in per) for name in per[0]}


def run(cell, program=port_program) -> Window:
    """One run of the cell (:class:`stereobench.run.Cell`): set-up, the
    open loop for ``cell.seconds``, then the check."""
    t = cell.traffic
    dev = cell.device
    rate = float(t["rate_hz"])
    p = prepare(cell, program)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        if cell.trace:
            trace.warm_up()
    n_due = max(1, math.floor(cell.seconds * rate))
    setup_s = time.perf_counter() - cell.t0
    loop = open_loop(p, dev, rate_hz=rate, seconds=cell.seconds,
                     keep=check_indices(cell.seed, n_due, t["check_triggers"]),
                     traced=max(4, round(PROFILED_SECONDS * rate)) if cell.trace else 0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tr = (trace.reduce(loop.prof, window_span="bench.window", units=loop.traced)
          if loop.prof is not None else None)

    # the check, once the program's state is freed
    p.forward = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    errors = check_errors(cell, p, loop.kept)
    # the work of a trigger, counted on the reference on the meta device
    meta_ref = cell.reference.build(cell.config["model"], "meta")
    shape = torch.empty(p.left.shape[1:], device="meta")
    flops = yardstick.model_flops(meta_ref, (shape, shape))
    _, conv_least = yardstick.conv_work(meta_ref, (shape, shape))
    answered = len(loop.latencies_s)
    checks = {name: {"value": errors[name], "limit": limit,
                     "ok": errors[name] <= limit}
              for name, limit in cell.limits.items()}
    checks["triggers_answered"] = {"value": answered, "limit": n_due,
                                   "ok": answered == n_due}
    return Window(latencies_s=loop.latencies_s, host_s=loop.host_s,
                  service_s=loop.service_s, window_s=loop.window_s, attempted=n_due,
                  failed=n_due - answered, units=answered, flops_per_unit=flops,
                  conv_least_s_per_unit=conv_least,
                  memory_peak_bytes=peak, checks=checks, trace=tr,
                  setup_s=setup_s)
