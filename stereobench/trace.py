"""The traced sub-window: ``torch.profiler`` over a few steady triggers or
steps, reduced to what the per-layer readers take.

The benchmark marks its own host spans with ``record_function`` (names
starting ``bench.``): they carry the profiler's clock, so the sub-window's
bounds and the label of each idle gap (what the host was doing meanwhile)
come from the same trace as the kernels.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from stereobench import yardstick

ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]


@dataclasses.dataclass
class Kernel:
    name: str
    start: float   # seconds, profiler clock
    end: float


@dataclasses.dataclass
class Trace:
    """Device operations and benchmark spans inside ``[lo, hi]`` (seconds,
    profiler clock), over ``units`` triggers or steps."""

    kernels: list
    spans: list          # (name, start, end, device seconds of the kernels
                         # launched inside) of the benchmark's host spans
    lo: float
    hi: float
    units: int

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def clipped(self, kernels=None):
        """(start, end) of ``kernels`` (all by default) clipped to the
        sub-window, empty ones dropped."""
        out = []
        for k in self.kernels if kernels is None else kernels:
            s, e = max(k.start, self.lo), min(k.end, self.hi)
            if e > s:
                out.append((s, e))
        return out

    def busy_s(self, within=None) -> float:
        """Seconds in which some operation ran on the device (the union of
        all kernel intervals, every stream), in the whole sub-window or in
        the disjoint (start, end) stretches ``within``."""
        kernels = self.clipped()
        if within is None:
            return yardstick.covered(kernels, self.lo, self.hi)
        return sum(yardstick.covered(kernels, s, e) for s, e in within)

    def outside(self, name: str):
        """The (start, end) stretches of the sub-window that no host span
        called ``name`` covers."""
        return yardstick.gaps([(sp[1], sp[2]) for sp in self.spans
                               if sp[0] == name], self.lo, self.hi)

    def device_s(self, keep) -> float:
        """Summed device seconds of the kernels whose name ``keep`` takes."""
        return sum(e - s for s, e in self.clipped(
            [k for k in self.kernels if keep(k.name)]))

    def by_group(self):
        """Device seconds by :func:`yardstick.kernel_group`, largest first."""
        acc = collections.Counter()
        for k in self.kernels:
            s, e = max(k.start, self.lo), min(k.end, self.hi)
            if e > s:
                acc[yardstick.kernel_group(k.name)] += e - s
        return acc.most_common()

    def span_device_s(self, name: str) -> float:
        """Device seconds of the kernels launched inside the host spans
        called ``name`` that start in the sub-window."""
        return sum(sp[3] for sp in self.spans
                   if sp[0] == name and self.lo <= sp[1] <= self.hi)

    def idle_gaps(self):
        """(label, seconds) of each stretch of the sub-window with nothing on
        the device, longest first; the label is the innermost benchmark span
        the host was in at the stretch's middle."""
        out = []
        for s, e in yardstick.gaps(self.clipped(), self.lo, self.hi):
            mid = (s + e) / 2
            inside = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
            label = (min(inside, key=lambda sp: sp[2] - sp[1])[0]
                     if inside else "outside the benchmark's spans")
            out.append((label, e - s))
        return sorted(out, key=lambda g: -g[1])


def warm_up() -> None:
    """Start and stop the profiler once on a trivial op, so the tracer's
    own start-up is paid in set-up."""
    with torch.profiler.profile(activities=ACTIVITIES):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def reduce(prof, *, window_span: str, units: int) -> Trace:
    """The :class:`Trace` of ``prof`` (a stopped profiler) between the start
    and end of its host span named ``window_span``."""
    kernels, spans = [], []
    for evt in prof.events():
        start, end = evt.time_range.start / 1e6, evt.time_range.end / 1e6
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            # a user annotation mirrored on the device spans kernels that
            # are counted themselves
            if getattr(evt, "is_user_annotation", False) or evt.name.startswith(
                    ("bench.", "Optimizer.")):
                continue
            kernels.append(Kernel(evt.name, start, end))
        elif evt.name.startswith("bench."):
            device_us = getattr(evt, "device_time_total", None)
            if device_us is None:
                device_us = evt.cuda_time_total
            spans.append((evt.name, start, end, device_us / 1e6))
    window = [sp for sp in spans if sp[0] == window_span]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} spans {window_span!r}")
    if not kernels:
        raise RuntimeError("the profiler recorded no device operation")
    _, lo, hi, _ = window[0]
    return Trace(kernels, spans, lo, hi, units)
