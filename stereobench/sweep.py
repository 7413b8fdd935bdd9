"""Find the highest trigger rate a camera cell sustains (its knee).

    python3 -m stereobench.sweep --workload <name> --seed <n> --seconds 4 --rates 40 50 60 ...

Sets the cell up once, then answers triggers back to back for
``--seconds`` (the closed-loop rate), then runs the cell's open loop at each
of ``--rates``, lowest first, for ``--seconds``.  A rate is sustained when
the window ends on time (every trigger answered within 2% of the window),
the last quarter's median latency is at most 1.5 times the first
quarter's (no backlog that grows), and the 95th percentile latency is at
most one period (triggers rarely wait for the one before).  The knee is
the highest rate below the first one not sustained.  Prints one JSON line
per rate and a last line with the knee; the cell's rate is set once, by
hand, to 4/5 of the knee, rounded down to a whole Hz.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from stereobench import isolation
from stereobench.loops import camera
from stereobench.run import load_cell
from stereobench.yardstick import percentile


def main(argv=None) -> int:
    isolation.block()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 3
    cell, _ = load_cell(args.workload, seed=args.seed, seconds=args.seconds,
                        trace=False, device="cuda:0", t0=time.perf_counter())
    p = camera.prepare(cell)
    dev = cell.device
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        p.forward(p.left[n % p.left.shape[0]], p.right[n % p.left.shape[0]])
        torch.cuda.synchronize(dev)
        n += 1
    closed = n / (time.perf_counter() - t0)
    print(json.dumps({"closed_loop_hz": closed,
                      "device": torch.cuda.get_device_name(dev)}), flush=True)
    knee, failed = None, False
    for rate in sorted(args.rates):
        loop = camera.open_loop(p, dev, rate_hz=rate, seconds=args.seconds)
        lat = [x * 1e3 for x in loop.latencies_s]
        q = max(1, len(lat) // 4)
        first, last = percentile(lat[:q], 50), percentile(lat[-q:], 50)
        on_time = loop.window_s <= args.seconds * 1.02 + max(lat) / 1e3
        p95 = percentile(lat, 95)
        sustained = on_time and last <= 1.5 * first and p95 <= 1e3 / rate
        failed = failed or not sustained
        if not failed:
            knee = rate
        print(json.dumps({"rate_hz": rate, "triggers": loop.due,
                          "window_s": loop.window_s,
                          "p50_ms": percentile(lat, 50),
                          "p95_ms": p95, "period_ms": 1e3 / rate,
                          "first_quarter_p50_ms": first,
                          "last_quarter_p50_ms": last,
                          "sustained": sustained}), flush=True)
    print(json.dumps({"workload": args.workload, "knee_hz": knee,
                      "rate_hz_at_4_5": math.floor(0.8 * knee) if knee else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
