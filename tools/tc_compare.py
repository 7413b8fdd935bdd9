#!/usr/bin/env python3
"""Side-by-side timings of the port's tensor-core convolutions on one card.

    python3 tools/tc_compare.py variants --out DIR [--only NAME ...]
    python3 tools/tc_compare.py in-turns --parent TREE --out DIR

``variants``: the tensor-core kernels (bf16: K1 and K3 32 -> 32 of
``csrc/conv_tc.cuh``, K1's narrow pairs of ``csrc/conv_narrow_tc.cuh``, K4 of
``csrc/dw_tc.cuh``, K2 and K2-4x4 of ``csrc/conv_s2_tc.cuh``, K3's narrow
pairs of ``csrc/conv3d_narrow_tc.cuh``) as built, with parts of their work
cut out (the ``RSM_TC_CUT_*`` macros of ``conv_tc.cuh``, which the other
headers include and test too), and K3's wgmma form
(``tools/conv_tc_wgmma.cuh`` in place of ``conv_tc.cuh``).  Each variant is
a copy of the package under ``DIR``,
built and timed in a process of its own; the variants run in turns
(A B ... B A); ``--only`` keeps the variants named.  A cut variant's
results are wrong by design: only its time means anything.

``in-turns``: a parent tree (a ``git archive`` of the parent commit,
unpacked) against the tree that holds this script, in the order parent,
change, change, parent.  In each: ``python3 chip_smoke.py`` (its log kept
under ``DIR``; frame and step medians and every kernel row read from it),
the timings below, then (``--profile``) ``frame_profile`` of the v1 / v2 /
v3 frames and training steps: device ms by kernel group, and the port
kernels of narrow channel pairs summed apart.

The timings: K1 at 720 x 1280 32 -> 32 +residual, dilations 1 and 8, K3
at (1, 24, 90, 160) and (4, 24, 60, 80), K4 at 4 x 480 x 640 (dilations 1
and 8) and (4, 24, 60, 80), K2-4x4 at 720 x 1280 and K2 at 360 x 640; the
narrow pairs at their largest launches (K1 1 / 3 / 4 / 7 -> 32 and 32 -> 1 /
4 / 7, K4 4 / 7 -> 32 and 32 -> 1 in 2D and 3D, K2 3 -> 32, K3 32 -> 1 and
1 -> 32); each beside the cuDNN call of
the same convolution (for K4 its weight gradient), read two ways: ``ms``, CUDA events around 20 calls, as
``chip_smoke.py``'s ``time_ms`` reads every row (where the host issues the
calls more slowly than the card runs them, this times the host too), and
``device_ms``, the same 20 calls queued behind a ~50 ms device sleep
(device time alone).  K3's largest error against its plain version is given
too, and K4's over its output's scale; and ``host_us``, the host time of one
call of the narrow K1 / K4 wrappers at a size the card runs in microseconds
(what a host-bound frame or step pays a launch).  One JSON line per run, a summary
in ``DIR/summary.json``, and as the last line the card's name and power
limit.  Needs one CUDA card and nvcc;
``DIR`` is best a directory git ignores (``_runs/``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG_NAME = "realtime_stereo_matcher_tpu_torch"
WGMMA = ROOT / "tools" / "conv_tc_wgmma.cuh"
# the macros of csrc/conv_tc.cuh each cut variant defines
VARIANTS = {
    "as built": (),
    "wgmma form": None,  # tools/conv_tc_wgmma.cuh in place of conv_tc.cuh
    "no MMA": ("RSM_TC_CUT_MMA",),
    "no A fragments": ("RSM_TC_CUT_A",),
    "no MMA, no A fragments": ("RSM_TC_CUT_MMA", "RSM_TC_CUT_A"),
    "no output stores": ("RSM_TC_CUT_STORE",),
}
SLEEP_CYCLES = 100_000_000  # ~50 ms at 1.98 GHz, as in chip_smoke.py


def make_variant(name: str, out: pathlib.Path) -> pathlib.Path:
    """A copy of the package under ``out/<name>`` with ``VARIANTS[name]``'s
    source; returns the directory to put on ``sys.path``."""
    root = out / name.replace(",", "").replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / PKG_NAME, root / PKG_NAME,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    header = root / PKG_NAME / "csrc" / "conv_tc.cuh"
    if VARIANTS[name] is None:
        shutil.copyfile(WGMMA, header)
    else:
        defines = "".join(f"#define {m}\n" for m in VARIANTS[name])
        header.write_text(defines + header.read_text())
    return root


def time_tree(tree: pathlib.Path) -> dict:
    """The K1 / K3 timings of the package in ``tree`` (in this process)."""
    sys.path.insert(0, str(tree))
    import torch
    import torch.nn.functional as F

    from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
        fused_conv3x3,
        fused_conv4x4_s2,
    )
    from realtime_stereo_matcher_tpu_torch.kernels.cost_filter3d import (
        fused_conv3d,
        fused_conv3d_plain,
    )
    from realtime_stereo_matcher_tpu_torch.kernels.train_conv import (
        dw_reduce,
        dw_reduce3d,
        dw_reduce3d_plain,
        dw_reduce_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 2 - 1

    def events_ms(fn, queued, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def both(kernel, library):
        return {"ms": events_ms(kernel, False),
                "library_ms": events_ms(library, False),
                "device_ms": events_ms(kernel, True),
                "library_device_ms": events_ms(library, True)}

    scale, bias = rand(32) * 0.5 + 1.0, rand(32) * 0.3
    out = {}
    x, r = rand(1, 720, 1280, 32).bfloat16(), rand(1, 720, 1280, 32).bfloat16()
    w = (rand(3, 3, 32, 32) / 17).bfloat16()
    x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
    for d in (1, 8):
        out[f"K1 720x1280 d{d} +res"] = both(
            lambda: fused_conv3x3(x, w, scale, bias, dilation=d, residual=r),
            lambda: F.conv2d(x_nchw, w_oihw, padding=d, dilation=d))
    w3 = (rand(3, 3, 3, 32, 32) / 29).bfloat16()
    w3_oidhw = w3.permute(4, 3, 0, 1, 2).contiguous()
    for vol in ((1, 24, 90, 160), (4, 24, 60, 80)):
        x3 = rand(*vol, 32).bfloat16()
        x3_ncdhw = x3.permute(0, 4, 1, 2, 3)
        key = f"K3 {'x'.join(map(str, vol))}"
        out[key] = both(lambda: fused_conv3d(x3, w3, scale, bias),
                        lambda: F.conv3d(x3_ncdhw, w3_oidhw, padding=1))
        ref = fused_conv3d_plain(x3.float(), w3.float(), scale, bias)
        out[key]["max_abs_err"] = float(
            (fused_conv3d(x3, w3, scale, bias).float() - ref).abs().max())
    for shape, d in (((4, 480, 640), 1), ((4, 480, 640), 8),
                     ((4, 24, 60, 80), None)):
        xg, gg = rand(*shape, 32).bfloat16(), rand(*shape, 32).bfloat16()
        x_nc, g_nc = xg.movedim(-1, 1), gg.movedim(-1, 1)
        if d is None:
            key = f"K4 3D {'x'.join(map(str, shape))}"
            fn = lambda: dw_reduce3d(xg, gg)
            lib = lambda: torch.nn.grad.conv3d_weight(
                x_nc, (32, 32, 3, 3, 3), g_nc, padding=1)
            ref = dw_reduce3d_plain(xg.float(), gg.float())
        else:
            key = f"K4 {'x'.join(map(str, shape))} d{d}"
            fn = lambda: dw_reduce(xg, gg, d)
            lib = lambda: torch.nn.grad.conv2d_weight(
                x_nc, (32, 32, 3, 3), g_nc, padding=d, dilation=d)
            ref = dw_reduce_plain(xg.float(), gg.float(), d)
        out[key] = both(fn, lib)
        out[key]["max_err_over_scale"] = float(
            (fn() - ref).abs().max() / ref.abs().max())
    for taps, hw in ((4, (720, 1280)), (3, (360, 640))):
        xs = rand(1, *hw, 32).bfloat16()
        ws = (rand(taps, taps, 32, 32) / (taps * 6)).bfloat16()
        xs_nchw, ws_oihw = xs.permute(0, 3, 1, 2), ws.permute(
            3, 2, 0, 1).contiguous()
        fn = ((lambda: fused_conv4x4_s2(xs, ws, scale, bias, act=0.2))
              if taps == 4 else
              (lambda: fused_conv3x3(xs, ws, scale, bias, stride=2)))
        out[f"K2{'-4x4' if taps == 4 else ''} {hw[0]}x{hw[1]}"] = both(
            fn, lambda: F.conv2d(xs_nchw, ws_oihw, stride=2, padding=1))
    # the narrow pairs at their largest launches
    for (cin, cout), shape, stride in (
            ((4, 32), (1, 720, 1280), 1), ((7, 32), (1, 720, 1280), 1),
            ((3, 32), (1, 720, 1280), 1), ((32, 1), (1, 720, 1280), 1),
            ((1, 32), (4, 480, 640), 1), ((32, 4), (4, 480, 640), 1),
            ((32, 7), (8, 240, 320), 1), ((3, 32), (1, 720, 1280), 2)):
        xn = rand(*shape, cin).bfloat16()
        wn = (rand(3, 3, cin, cout) / (3 * cin ** 0.5)).bfloat16()
        sn, bn = scale[:cout].contiguous(), bias[:cout].contiguous()
        xn_nchw, wn_oihw = xn.permute(0, 3, 1, 2), wn.permute(
            3, 2, 0, 1).contiguous()
        name = "K2" if stride == 2 else "K1"
        out[f"{name} {'x'.join(map(str, shape))} {cin}->{cout}"] = both(
            lambda: fused_conv3x3(xn, wn, sn, bn, stride=stride),
            lambda: F.conv2d(xn_nchw, wn_oihw, stride=stride, padding=1))
    for kd, (cin, cout), shape in ((1, (4, 32), (4, 480, 640)),
                                   (1, (7, 32), (8, 240, 320)),
                                   (1, (32, 1), (4, 480, 640)),
                                   (3, (32, 1), (4, 24, 60, 80))):
        xg, gg = rand(*shape, cin).bfloat16(), rand(*shape, cout).bfloat16()
        x_nc, g_nc = xg.movedim(-1, 1), gg.movedim(-1, 1)
        if kd == 3:
            fn = lambda: dw_reduce3d(xg, gg)
            lib = lambda: torch.nn.grad.conv3d_weight(
                x_nc, (cout, cin, 3, 3, 3), g_nc, padding=1)
        else:
            fn = lambda: dw_reduce(xg, gg)
            lib = lambda: torch.nn.grad.conv2d_weight(
                x_nc, (cout, cin, 3, 3), g_nc, padding=1)
        out[f"K4{' 3D' if kd == 3 else ''} {'x'.join(map(str, shape))} "
            f"{cin}->{cout}"] = both(fn, lib)
    # host time of one wrapper call (its enqueue: plan, checks, ctypes,
    # launch) at a size the card runs in a few microseconds, which is what
    # the host-bound frames and steps pay per launch
    for key, fn in host_calls(rand):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        out[key] = {"host_us": (time.perf_counter() - t0) / 200 * 1e6}
        torch.cuda.synchronize()
    for (cin, cout), vol in (((32, 1), (1, 24, 90, 160)),
                             ((1, 32), (4, 24, 60, 80))):
        x3 = rand(*vol, cin).bfloat16()
        w3n = (rand(3, 3, 3, cin, cout) / (5 * cin ** 0.5)).bfloat16()
        sn, bn = scale[:cout].contiguous(), bias[:cout].contiguous()
        x3_ncdhw = x3.permute(0, 4, 1, 2, 3)
        w3n_oidhw = w3n.permute(4, 3, 0, 1, 2).contiguous()
        out[f"K3 {'x'.join(map(str, vol))} {cin}->{cout}"] = both(
            lambda: fused_conv3d(x3, w3n, sn, bn, relu=False),
            lambda: F.conv3d(x3_ncdhw, w3n_oidhw, padding=1))
    return out


def host_calls(rand):
    """(name, call) of the narrow wrappers on 1 x 16 x 64 tensors, whose
    host time ``time_tree`` reads: K1 4 -> 32 and 32 -> 1, K4 4 -> 32 and
    32 -> 1."""
    import torch

    from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
        fused_conv3x3,
    )
    from realtime_stereo_matcher_tpu_torch.kernels.train_conv import dw_reduce

    calls = []
    for cin, cout in ((4, 32), (32, 1)):
        x = rand(1, 16, 64, cin).bfloat16()
        w = (rand(3, 3, cin, cout) * 0.1).bfloat16()
        g = rand(1, 16, 64, cout).bfloat16()
        scale = torch.ones(cout, device=x.device)
        bias = torch.zeros(cout, device=x.device)
        calls.append((f"host K1 1x16x64 {cin}->{cout}",
                      lambda x=x, w=w, s=scale, b=bias:
                      fused_conv3x3(x, w, s, b)))
        calls.append((f"host K4 1x16x64 {cin}->{cout}",
                      lambda x=x, g=g: dw_reduce(x, g)))
    return calls


def _run(cmd, cwd, log: pathlib.Path) -> int:
    with open(log, "w") as f:
        return subprocess.run(cmd, cwd=cwd, stdout=f, stderr=subprocess.STDOUT,
                              timeout=1200).returncode


def _child_times(tree: pathlib.Path, log: pathlib.Path) -> dict:
    rc = _run([sys.executable, str(pathlib.Path(__file__).resolve()), "time",
               "--root", str(tree.resolve())], ROOT, log)
    lines = log.read_text().splitlines()
    if rc or not lines:
        raise RuntimeError(f"timing {tree} failed ({rc}); see {log}")
    return json.loads(lines[-1])


def _smoke_numbers(log: pathlib.Path) -> dict:
    """K1 / K3 rows and the frame and step medians of a chip_smoke.py log."""
    got = {}
    for line in log.read_text().splitlines():
        if line.startswith('{"kernels"'):
            got["kernels"] = {k["name"]: {key: k.get(key) for key in (
                "ms", "library_ms", "plain_ms", "bound_ms", "device_ms")}
                for k in json.loads(line)["kernels"]}
        elif line.startswith('{"frame_latency_ms"'):
            rec = json.loads(line)
            got["frame_ms_median"] = {
                "v1": rec["frame_latency_ms"]["median"],
                "v2": rec["v2"]["frame_latency_ms"]["median"],
                "v3": rec["v3"]["frame_latency_ms"]["median"]}
            got["step_ms_median"] = {
                m: rec[key]["median"] for m, key in (
                    ("v1", "train_step_ms"), ("v2", "train_step_ms_v2"),
                    ("v3", "train_step_ms_v3"))}
    return got


# frame_profile runs of ``in-turns --profile``: (label, arguments)
PROFILES = (("v1 frame", []), ("v2 frame", ["--model", "v2"]),
            ("v3 frame", ["--model", "v3"]),
            ("v1 step", ["--train", "--frames", "4"]),
            ("v2 step", ["--train", "--model", "v2", "--frames", "4"]),
            ("v3 step", ["--train", "--model", "v3", "--frames", "4"]))
NARROW_ROUTE = re.compile(r"^(fused_conv3x3|fused_conv3x3_s2|fused_conv3d|"
                          r"fused_conv4x4_s2|dw_reduce)( 3D)? \d+->\d+$")


def _profiles(tree: pathlib.Path, out: pathlib.Path, tag: str) -> dict:
    """``frame_profile`` of each of ``PROFILES`` in ``tree``: device ms,
    busy share, and the port kernels of narrow pairs (any but 32 -> 32),
    by group and in all."""
    got = {}
    for label, extra in PROFILES:
        log = out / f"profile_{tag}_{label.replace(' ', '_')}.log"
        rc = _run([sys.executable, "-m", f"{PKG_NAME}.frame_profile", *extra],
                  tree, log)
        lines = log.read_text().splitlines()
        if rc or not lines:
            raise RuntimeError(f"frame_profile {label} in {tree} failed "
                               f"({rc}); see {log}")
        rec = json.loads(lines[-1])
        narrow = {g: v for g, v in rec["groups"].items()
                  if NARROW_ROUTE.match(g) and not g.endswith(" 32->32")}
        got[label] = {
            "device_ms": rec["device_ms_per_frame"],
            "busy_share": rec["busy_share"],
            "narrow_ms": sum(v["ms_per_frame"] for v in narrow.values()),
            "narrow_launches": sum(v["launches_per_frame"]
                                   for v in narrow.values()),
            "narrow_groups": narrow,
            "narrow_by_route": rec.get("narrow_pairs")}
    return got


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("variants")
    v.add_argument("--out", type=pathlib.Path, required=True)
    v.add_argument("--only", nargs="+", choices=list(VARIANTS),
                   help="the variants to time (default: all)")
    t = sub.add_parser("in-turns")
    t.add_argument("--parent", type=pathlib.Path, required=True)
    t.add_argument("--out", type=pathlib.Path, required=True)
    t.add_argument("--profile", action="store_true",
                   help="also profile the frames and steps in each run")
    c = sub.add_parser("time")
    c.add_argument("--root", type=pathlib.Path, required=True)
    args = ap.parse_args(argv)
    if args.cmd == "time":
        print(json.dumps(time_tree(args.root)), flush=True)
        return 0

    args.out.mkdir(parents=True, exist_ok=True)
    runs = []
    if args.cmd == "variants":
        names = args.only or list(VARIANTS)
        trees = {name: make_variant(name, args.out / "variants")
                 for name in names}
        for i, name in enumerate(names + names[::-1]):
            log = args.out / f"variant_{i}.log"
            runs.append({"variant": name,
                         "times": _child_times(trees[name], log)})
            print(json.dumps(runs[-1]), flush=True)
    else:
        trees = {"parent": args.parent.resolve(), "change": ROOT}
        for i, label in enumerate(("parent", "change", "change", "parent")):
            log = args.out / f"smoke_{i}_{label}.log"
            rc = _run([sys.executable, "chip_smoke.py"], trees[label], log)
            runs.append({"run": i, "tree": label, "chip_smoke_rc": rc,
                         **_smoke_numbers(log),
                         "times": _child_times(
                             trees[label], args.out / f"times_{i}_{label}.log")})
            if args.profile:
                runs[-1]["profiles"] = _profiles(trees[label], args.out,
                                                 f"{i}_{label}")
            print(json.dumps(runs[-1]), flush=True)
    card = smi()
    (args.out / "summary.json").write_text(json.dumps(
        {"card": card, "runs": runs}, indent=1))
    print(card)
    return 0 if all(r.get("chip_smoke_rc", 0) == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
