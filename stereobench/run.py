"""Run one cell of the benchmark once and print its result line.

    python3 -m stereobench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Everything is found by name: the cell in
``BENCHMARK.json``'s ``workloads``; its configuration's file there, and
the plain reference that file's ``reference`` key names; its traffic in
``stereobench/traffic/<traffic>.json``, whose ``loop`` names the
generator ``stereobench/loops/<loop>.py``; its limits in
``stereobench/workloads/<cell>.json``; each metric's reader in
``stereobench/metrics/<metric>.py``.  With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.

The run needs as many CUDA cards as the cell asks for and fails without
them; it never falls back to the CPU.  It refuses to load JAX or the JAX
package, and fails if either is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()  # before the heavy imports: set-up starts here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "stereobench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from stereobench import isolation  # noqa: E402

isolation.block()

import torch  # noqa: E402

# caches of the program's builds, at fixed paths inside the checkout
CACHE = ROOT / "_runs" / "stereobench"


@dataclasses.dataclass
class Cell:
    name: str
    seed: int
    seconds: float
    trace: bool
    chips: int
    config: dict
    traffic: dict
    limits: dict
    device: torch.device
    t0: float
    reference: types.ModuleType   # the configuration's plain reference


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, *, seed: int, seconds: float, trace: bool,
              device, t0: float, root: pathlib.Path = ROOT):
    """The :class:`Cell` of ``name`` and the metric entries it reports,
    found by name under ``root``."""
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config_file = _json(root / config["file"])
    cell = Cell(name=name, seed=seed, seconds=seconds, trace=trace,
                chips=entry["chips"], config=config_file,
                traffic=_json(root / "stereobench" / "traffic"
                              / f"{entry['traffic']}.json"),
                limits=_json(root / "stereobench" / "workloads"
                             / f"{name}.json")["limits"],
                device=torch.device(device), t0=t0,
                reference=load_reference(config_file, config["file"], root))
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind] if name in m.get("workloads", [name])]
    return cell, metrics


def _load_file(path: pathlib.Path, package: str = "stereobench.metrics"):
    spec = importlib.util.spec_from_file_location(
        f"{package}.{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reference(config: dict, where: str, root: pathlib.Path = ROOT):
    """The module that the configuration's ``reference`` key names: a
    ``.py`` file under ``root``, with ``build(model_config, device)``.
    ``where`` names the configuration's file in the messages."""
    rel = config.get("reference")
    path = root / rel if isinstance(rel, str) and rel.endswith(".py") else None
    if path is None or not path.is_file():
        raise ValueError(f"{where}: its key 'reference' has to name the .py "
                         f"file of its plain reference under the checkout, "
                         f"not {rel!r}")
    try:
        module = _load_file(path, "stereobench.reference")
    except (OSError, SyntaxError, ImportError) as e:
        raise ValueError(f"{where}: the module that its key 'reference' "
                         f"names ({rel}) does not load: {e}") from e
    if not callable(getattr(module, "build", None)):
        raise ValueError(f"{where}: the module that its key 'reference' "
                         f"names ({rel}) has no build(model_config, device)")
    return module


def read_metrics(window, metrics, root: pathlib.Path = ROOT) -> dict:
    """``{name: {"value", "unit"}}`` of each metric whose reader (found by
    its name) finds something to read."""
    out = {}
    for m in metrics:
        value = _load_file(root / "stereobench" / "metrics"
                           / f"{m['name']}.py").read(window)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, metrics, program=None, root: pathlib.Path = ROOT):
    """Run the cell's loop and build the result line (a dict)."""
    loop = importlib.import_module(f"stereobench.loops.{cell.traffic['loop']}")
    window = (loop.run(cell) if program is None
              else loop.run(cell, program=program))
    device = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.device.type == "cuda" else "cpu"),
              "count": cell.chips,
              "memory_peak_bytes": int(window.memory_peak_bytes)}
    result = {"correct": (window.failed == 0
                          and all(c["ok"] for c in window.checks.values())),
              "attempted": window.attempted, "failed": window.failed,
              "metrics": read_metrics(window, metrics, root),
              "device": device}
    if window.trace is not None:
        tr = window.trace
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": [list(g) for g in tr.by_group()[:10]],
                               "idle_gaps": [list(g) for g in tr.idle_gaps()[:10]]}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in window.checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, metrics = load_cell(args.workload, seed=args.seed,
                              seconds=args.seconds, trace=bool(args.trace),
                              device="cuda:0", t0=T0)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"stereobench: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    torch.cuda.set_device(cell.device)

    result = run_cell(cell, metrics)
    leaked = isolation.forbidden_loaded()
    if leaked:
        print(f"stereobench: loaded {leaked} in the benchmark's process",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
