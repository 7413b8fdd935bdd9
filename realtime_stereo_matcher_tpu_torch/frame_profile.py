"""Where the device time of a 720p frame goes, by kernel.

    python -m realtime_stereo_matcher_tpu_torch.frame_profile [--frames 8]

Builds v1 as ``bench.py`` does, runs ``--frames`` frames of the bf16 kernel
path under ``torch.profiler`` after two warm-up frames, and prints one JSON
line: per group of device kernels (each hand-written kernel by its template
shape, and the plain PyTorch ops by name) the device ms per frame and the
launches per frame, plus the device busy share over the profiled span
(kernel time / span from the first kernel's start to the last one's end).
Kernels of one stream do not overlap, so the sum is the busy time.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys

import torch

from realtime_stereo_matcher_tpu_torch import bench
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.fast_infer import make_fast_forward

# rsm::conv_kernel<T, CI, CO, S, KD>
_CONV = re.compile(r"conv_kernel<([^,]+),\s*(\d+),\s*(\d+),\s*(\d+),\s*(\d+)>")


def kernel_group(name: str) -> str:
    """A device kernel's group: the port's conv kernel by (kernel, C_in,
    C_out), anything else by its name up to the template arguments."""
    m = _CONV.search(name)
    if m:
        _, ci, co, s, kd = m.groups()
        kernel = ("fused_conv3d" if kd == "3" else
                  "fused_conv3x3_s2" if s == "2" else "fused_conv3x3")
        return f"{kernel} {ci}->{co}"
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return "plain: " + name.split("<")[0].split("(")[0][:80].strip()


def profile_frames(frames: int = 8, seed: int = 0) -> dict:
    dev = torch.device("cuda", 0)
    model = build_model(json.loads(bench.CONFIG.read_text())["model"],
                        device=dev, generator=torch.Generator().manual_seed(seed))
    forward = make_fast_forward(model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    left, right = (torch.rand((1, *bench.HW, 3), generator=gen, device=dev)
                   * 255 for _ in range(2))
    for _ in range(2):
        forward(left, right)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(frames):
            forward(left, right)
        torch.cuda.synchronize()

    time_us = collections.Counter()
    count = collections.Counter()
    starts, ends = [], []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = kernel_group(evt.name)
        time_us[group] += evt.time_range.elapsed_us()
        count[group] += 1
        starts.append(evt.time_range.start)
        ends.append(evt.time_range.end)
    if not time_us:
        raise RuntimeError("the profiler recorded no device kernels")
    busy = sum(time_us.values())
    span = max(ends) - min(starts)
    groups = {g: {"ms_per_frame": t / 1e3 / frames,
                  "launches_per_frame": count[g] / frames}
              for g, t in time_us.most_common()}
    return {"frames": frames, "device": torch.cuda.get_device_name(dev),
            "device_ms_per_frame": busy / 1e3 / frames,
            "span_ms_per_frame": span / 1e3 / frames,
            "busy_share": busy / span, "groups": groups}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("frame_profile: CUDA is not available", file=sys.stderr)
        return 1
    print(json.dumps(profile_frames(args.frames)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
