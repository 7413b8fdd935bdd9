"""Flagship benchmark of the port: MobileStereoNet at 1280x720 on one CUDA card.

    python -m realtime_stereo_matcher_tpu_torch.bench [--model v1|v2|v3] [--pairs 8] [--seed 0]

Builds the model (v1 from ``configure/stereo_net_config.json``, the default;
v2 and v3 from ``configure/stereo_net_config_v2.json`` and ``_v3.json``)
with weights drawn from
``--seed``, answers ``--pairs`` random 720p stereo pairs (batch 1, eval mode)
through the bf16 kernel path, and prints one JSON line:

    {"metric": "mobile_stereo_net_720p_fps" (v2, v3: "mobile_stereo_net_v2_720p_fps",
               "mobile_stereo_net_v3_720p_fps"),
     "value": <1000 / median ms>,
     "unit": "frames/s", "latency_ms": {"min": ..., "median": ...},
     "device": <card name>, "path": "kernel", "degraded": false, ...}

Each frame is timed on the card with CUDA events, back to back after
``warmup`` frames; min and median are over the pairs.  The kernel path is the
only path: if it cannot be built or run the command fails, it never times a
slower path in its place (so ``degraded`` is always false when a line is
printed).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

import torch

from realtime_stereo_matcher_tpu_torch import resolve_device
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.fast_infer import make_fast_forward

CONFIGURE = pathlib.Path(__file__).resolve().parent.parent / "configure"
# per model: (repo config, metric name)
MODELS = {"v1": (CONFIGURE / "stereo_net_config.json",
                 "mobile_stereo_net_720p_fps"),
          "v2": (CONFIGURE / "stereo_net_config_v2.json",
                 "mobile_stereo_net_v2_720p_fps"),
          "v3": (CONFIGURE / "stereo_net_config_v3.json",
                 "mobile_stereo_net_v3_720p_fps")}
CONFIG = MODELS["v1"][0]
HW = (720, 1280)


def model_config(model: str = "v1") -> dict:
    """The ``model`` section of the repo config of ``model`` (v1, v2, v3)."""
    return json.loads(MODELS[model][0].read_text())["model"]


def run_bench(pairs: int = 8, seed: int = 0, *, warmup: int = 2,
              device="cuda", model: str = "v1") -> dict:
    """Answer ``pairs`` random 720p pairs on ``model``'s kernel path; return
    the record.

    Raises if the outputs are not finite negative disparities of the input's
    size."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the benchmark times CUDA kernels; device must be cuda")
    net = build_model(model_config(model), device=dev,
                      generator=torch.Generator().manual_seed(seed))
    forward = make_fast_forward(net, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = [tuple(torch.rand((1, *HW, 3), generator=gen, device=dev) * 255
                    for _ in range(2)) for _ in range(pairs)]

    for i in range(warmup):
        forward(*frames[i % pairs])
    torch.cuda.synchronize(dev)
    events, outs = [], []
    for left, right in frames:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(forward(left, right)[-1])
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(dev)
    ms = [s.elapsed_time(e) for s, e in events]

    for out in outs:
        if out.shape != (1, *HW, 1) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"bad disparity: shape {tuple(out.shape)}")
        if float(out.max()) > 0.0:
            raise RuntimeError("disparity must be negative flow (<= 0)")
    median = statistics.median(ms)
    return {
        "metric": MODELS[model][1],
        "value": 1000.0 / median,
        "unit": "frames/s",
        "latency_ms": {"min": min(ms), "median": median},
        "device": torch.cuda.get_device_name(dev),
        "path": "kernel",
        "degraded": False,
        "pairs": pairs,
        "warmup": warmup,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="v1")
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: CUDA is not available; the benchmark needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    print(json.dumps(run_bench(args.pairs, args.seed, model=args.model)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
