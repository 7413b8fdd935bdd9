"""The program's stages in a traced sub-window: its ``rsm.`` host spans, the
CUDA runtime calls that launch work on the card or block the host on it,
and the device operations each stage launched (not run by the benchmark's
runs).

    python3 -m stereobench.stages --workload <name> --seed <n> [--seconds 8] [--out <file>]

sets the cell up as a run does, runs its loop with a sub-window under
``torch.profiler`` as a ``--trace 1`` run traces it (a camera cell's
triggers in the middle of an open loop at its rate; a training cell's
steps between synchronises), and prints one JSON line: per traced unit
each stage's launches, blocking calls and device ms, the idle gaps labelled
by the innermost span, the host's enqueue under the profiler and without
it, and the kernel wrappers' own count (``kernels/_build.LAUNCHES``).

:func:`reduce` takes the stopped profiler that ``trace.reduce`` takes.  An
operation belongs to a span by its launch: the runtime call that launched
it (matched by correlation id) starts inside the span's interval, on any
thread, as autograd runs the backward on a thread of its own.  The device
mirrors of the program's annotations are dropped as ``trace.reduce`` drops
the benchmark's.  On a program with no ``rsm.`` span every per-stage number
is None.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import pathlib
import sys
import time
import types

import torch

from stereobench import isolation, readers, trace, yardstick
from stereobench.loops import camera, train

PROGRAM = "rsm."
# CUDA calls (`cuda*` and their `cu*` forms) that put work on a stream
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                   "cudaLaunchCooperativeKernel")
LAUNCH_NAMES = frozenset({"cudaMemcpyAsync", "cudaMemsetAsync"})
# calls that wait for the card
SYNC_NAMES = frozenset({"cudaDeviceSynchronize", "cudaStreamSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
DTOH = "Memcpy DtoH"
# the spans a frame and a step are read in
FRAME = ("rsm.forward",)
STEP = ("rsm.fetch", "rsm.augment", "rsm.step")
STAGES = ("rsm.extract", "rsm.cost", "rsm.refine", "rsm.loss",
          "rsm.backward", "rsm.optimizer", "rsm.fetch", "rsm.augment")


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_PREFIXES) or name in LAUNCH_NAMES


def is_mirror(evt) -> bool:
    """A device-side copy of a host annotation (``trace.reduce``'s rule, with
    the program's prefix)."""
    return bool(getattr(evt, "is_user_annotation", False)) or evt.name.startswith(
        ("bench.", "Optimizer.", PROGRAM))


@dataclasses.dataclass
class Call:
    name: str
    start: float        # seconds, profiler clock
    corr: int           # correlation id of what it launched
    blocks: bool        # waits for the card


@dataclasses.dataclass
class Stages:
    """The program's spans, the runtime calls and the device operations of
    a traced sub-window ``[lo, hi]`` over ``units`` triggers or steps."""

    spans: list          # (name, start, end) of rsm. and bench. host spans
    calls: list          # Call, by start
    ops: dict            # correlation id -> [(name, start, end)]
    lo: float
    hi: float
    units: int

    def __post_init__(self):
        self._starts = [c.start for c in self.calls]

    @property
    def has_program(self) -> bool:
        return any(sp[0].startswith(PROGRAM) for sp in self.spans)

    def intervals(self, names) -> list:
        """(start, end) of the spans that start in the sub-window and are
        called one of ``names`` or named under one (``rsm.refine`` takes
        every level), nested ones merged into the outer."""
        picked = sorted((s, e) for n, s, e in self.spans
                        if self.lo <= s <= self.hi
                        and any(n == m or n.startswith(m + ".") for m in names))
        return yardstick.union_intervals(picked)

    def calls_in(self, names) -> list:
        out = []
        for s, e in self.intervals(names):
            i, j = bisect.bisect_left(self._starts, s), bisect.bisect_right(self._starts, e)
            out.extend(self.calls[i:j])
        return out

    def launches(self, names):
        """Launch calls a unit that start inside the spans ``names``."""
        if not self.has_program:
            return None
        return sum(is_launch(c.name) for c in self.calls_in(names)) / self.units

    def syncs(self, names):
        """Calls a unit, starting inside the spans ``names``, that block the
        host on the card."""
        if not self.has_program:
            return None
        return sum(c.blocks for c in self.calls_in(names)) / self.units

    def launched_ops(self, names) -> list:
        return [op for c in self.calls_in(names) for op in self.ops.get(c.corr, ())]

    def device_ms(self, names):
        """Device ms a unit of the operations launched inside the spans
        ``names``."""
        if not self.has_program:
            return None
        return sum(e - s for _, s, e in self.launched_ops(names)) / self.units * 1e3

    def device_ops(self, names):
        """Device operations a unit launched inside the spans ``names``."""
        if not self.has_program:
            return None
        return len(self.launched_ops(names)) / self.units

    def unlaunched_ops(self) -> int:
        """Device operations in the sub-window whose launch the trace does
        not hold."""
        launched = {c.corr for c in self.calls if is_launch(c.name)}
        return sum(1 for corr, ops in self.ops.items() if corr not in launched
                   for _, s, _ in ops if self.lo <= s <= self.hi)

    def host_ms(self, name: str):
        """Host ms a unit inside the spans ``name`` that start in the
        sub-window."""
        spans = self.intervals([name])
        return (sum(e - s for s, e in spans) / self.units * 1e3 if spans
                else None)

    def label(self, at: float) -> str:
        inside = [sp for sp in self.spans if sp[1] <= at <= sp[2]]
        return (min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside
                else "outside the benchmark's spans")

    def idle_gaps(self, tr: trace.Trace):
        """``tr.idle_gaps()`` (lengths and order the same), each labelled by
        the innermost span, the program's or the benchmark's, open at its
        middle."""
        out = [(self.label((s + e) / 2), e - s)
               for s, e in yardstick.gaps(tr.clipped(), tr.lo, tr.hi)]
        return sorted(out, key=lambda g: -g[1])

    def idle_ms_by_span(self, tr: trace.Trace) -> dict:
        """Idle ms a unit by the innermost span open at each gap's middle,
        largest first."""
        acc = collections.Counter()
        for name, s in self.idle_gaps(tr):
            acc[name] += s / self.units * 1e3
        return dict(acc.most_common())


def reduce(prof, *, window_span: str, units: int) -> Stages:
    """The :class:`Stages` of ``prof`` (a stopped profiler) between the start
    and end of its host span named ``window_span``."""
    spans, calls, ops, dtoh = [], [], {}, set()
    for evt in prof.events():
        start, end = evt.time_range.start / 1e6, evt.time_range.end / 1e6
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if is_mirror(evt):
                continue
            ops.setdefault(evt.id, []).append((evt.name, start, end))
            if evt.name.startswith(DTOH):
                dtoh.add(evt.id)
        elif evt.name.startswith((PROGRAM, "bench.")):
            spans.append((evt.name, start, end))
        elif is_launch(evt.name) or evt.name in SYNC_NAMES:
            calls.append(Call(evt.name, start, evt.id, evt.name in SYNC_NAMES))
    for c in calls:
        c.blocks = c.blocks or c.corr in dtoh
    window = [sp for sp in spans if sp[0] == window_span]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} spans {window_span!r}")
    _, lo, hi = window[0]
    calls.sort(key=lambda c: c.start)
    return Stages(spans, calls, ops, lo, hi, units)


def table(st: Stages, unit_spans) -> dict:
    """Per unit: launches, blocking calls, device operations and device ms
    of the whole unit (``unit_spans``) and of each stage."""
    out = {"launches": st.launches(unit_spans), "syncs": st.syncs(unit_spans),
           "device_ops": st.device_ops(unit_spans),
           "device_ms": st.device_ms(unit_spans), "stages": {}}
    for name in STAGES:
        if st.intervals([name]):
            out["stages"][name] = {"launches": st.launches([name]),
                                   "syncs": st.syncs([name]),
                                   "device_ms": st.device_ms([name]),
                                   "host_ms": st.host_ms(name)}
    out["unlaunched_ops"] = st.unlaunched_ops() / st.units
    return out


def _wrapper_calls() -> int:
    from realtime_stereo_matcher_tpu_torch.kernels import LAUNCHES
    return sum(LAUNCHES.values())


def _camera(cell, seconds: float) -> dict:
    rate = float(cell.traffic["rate_hz"])
    p = camera.prepare(cell)
    trace.warm_up()
    traced = max(4, round(camera.PROFILED_SECONDS * rate))
    before = _wrapper_calls()
    loop = camera.open_loop(p, cell.device, rate_hz=rate, seconds=seconds,
                            traced=traced)
    wrapper = (_wrapper_calls() - before) / loop.due
    tr = trace.reduce(loop.prof, window_span="bench.window", units=traced)
    st = reduce(loop.prof, window_span="bench.window", units=traced)
    return {"unit": "trigger", "host_ms_untraced": readers.host_ms(loop),
            "enqueue_ms_traced": st.host_ms("bench.forward enqueue"),
            "wrapper_calls": wrapper, "tr": tr, "st": st, "frame": FRAME}


def _train(cell, seconds: float) -> dict:
    t, dev = cell.traffic, cell.device
    trainer, *_ = train.prepare(cell)
    torch.cuda.synchronize(dev)
    trace.warm_up()
    table_ = train.index_table(cell.seed, t["scenes"], t["batch_size"], 100_000, dev)
    k, host = train.CHECK_STEPS, []
    before = _wrapper_calls()
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        t_call = time.perf_counter()
        trainer.step(k, table_[k])
        host.append(time.perf_counter() - t_call)
        k += 1
    wrapper = (_wrapper_calls() - before) / len(host)
    prof = torch.profiler.profile(activities=trace.ACTIVITIES)
    prof.start()
    torch.cuda.synchronize(dev)
    with torch.profiler.record_function("bench.window"):
        for _ in range(train.PROFILED_STEPS):
            trainer.step(k, table_[k])
            k += 1
        torch.cuda.synchronize(dev)
    prof.stop()
    units = train.PROFILED_STEPS
    tr = trace.reduce(prof, window_span="bench.window", units=units)
    st = reduce(prof, window_span="bench.window", units=units)
    enqueue = [st.host_ms(n) for n in ("bench.fetch and augment", "bench.step")]
    return {"unit": "step", "host_ms_untraced": sum(host) / len(host) * 1e3,
            "enqueue_ms_traced": (None if None in enqueue else sum(enqueue)),
            "wrapper_calls": wrapper, "tr": tr, "st": st, "frame": STEP}


def measure(cell, seconds: float) -> dict:
    """The stage table of one traced sub-window of ``cell``."""
    got = (_camera if cell.traffic["loop"] == "camera" else _train)(cell, seconds)
    tr, st = got.pop("tr"), got.pop("st")
    unit_spans = got.pop("frame")
    window = types.SimpleNamespace(trace=tr)
    port_ops = (sum(yardstick.is_port_kernel(n) for n, _, _ in st.launched_ops(unit_spans))
                / st.units if st.has_program else None)
    return {**got, "units": st.units, "program_spans": st.has_program,
            **table(st, unit_spans),
            "port_kernel_ops": port_ops,
            "all_device_ms": tr.device_s(lambda n: True) / tr.units * 1e3,
            "idle_pct": readers.idle_pct(window),
            "plain_ms": readers.plain_ms(window),
            "mirrors_as_kernels": sum(k.name.startswith(PROGRAM) for k in tr.kernels),
            "idle_ms_by_span": st.idle_ms_by_span(tr),
            "idle_gaps": [[n, s * 1e3] for n, s in st.idle_gaps(tr)[:10]]}


def main(argv=None) -> int:
    isolation.block()
    from stereobench.run import load_cell  # its import blocks JAX too

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stages: needs a CUDA card", file=sys.stderr)
        return 3
    cell, _ = load_cell(args.workload, seed=args.seed, seconds=args.seconds,
                        trace=True, device="cuda:0", t0=time.perf_counter())
    torch.cuda.set_device(cell.device)
    line = {"workload": args.workload, "seed": args.seed,
            **measure(cell, args.seconds),
            "device": torch.cuda.get_device_name(0)}
    text = json.dumps(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
