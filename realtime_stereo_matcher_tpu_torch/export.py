"""Deployment export of the port (port of
``realtime_stereo_matcher_tpu/export.py``; reference tools/convert.py:5-26,
which exports ``model(left, right)`` at a fixed shape with named ``left`` /
``right`` inputs).

The JAX package serializes the eval forward as a StableHLO module.  Here the
artifact is a ``torch.export`` program: the plain eval forward's last
output, traced at fixed (B, H, W, 3) float32 ``left`` / ``right`` shapes
with the weights inside, saved with ``torch.export.save`` and a JSON file
of metadata beside it.  It is the plain forward, as the JAX package exports
``model.apply``: the kernel path's launches are ctypes calls, which a trace
cannot hold.  A program loads where the same torch version runs (the
format is torch's), so export and load on one machine.

* :func:`aot_compile` -- the serving function fixed to one input shape on
  the local device, refusing any other: on a CUDA device the plain forward
  captured once in a CUDA graph and replayed (the counterpart of the JAX
  package's compiled executable, which never retraces), with
  ``device="cpu"`` the exported program's module.

ONNX, the reference's format, is not written: the ``onnx`` package is
absent from both machines.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch import nn


class ServingModule(nn.Module):
    """``forward(left, right)`` -> the model's last (finest) negative
    disparity map (B, H, W, 1), eval mode."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model.eval()

    def forward(self, left, right):
        return self.model(left, right)[-1]


def make_serving_fn(model: nn.Module) -> ServingModule:
    """The model's eval forward with its weights: (left, right) -> the final
    negative disparity map."""
    return ServingModule(model)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _example(model, image_hw, batch_size, dtype):
    h, w = image_hw
    return torch.zeros((batch_size, h, w, 3), dtype=dtype,
                       device=_device(model))


def export_program(model, *, image_hw, batch_size: int = 1,
                   dtype=torch.float32):
    """The ``torch.export`` program of the serving function at fixed
    (``batch_size``, H, W, 3) ``dtype`` inputs, on the model's device."""
    # two tensors: one passed twice would be traced as one input
    example = tuple(_example(model, image_hw, batch_size, dtype)
                    for _ in range(2))
    with torch.no_grad():
        return torch.export.export(make_serving_fn(model), example)


def export_stereo_model(model, *, image_hw, output_file, batch_size: int = 1,
                        dtype=torch.float32) -> Path:
    """Write the serving program to ``output_file`` (``torch.export.save``)
    and its metadata to ``<output_file>.json``; returns the path."""
    program = export_program(model, image_hw=image_hw, batch_size=batch_size,
                             dtype=dtype)
    out = Path(output_file)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, out)
    meta = {
        "input_shape": [batch_size, *image_hw, 3],
        "dtype": str(dtype).removeprefix("torch."),
        "device": str(_device(model)),
        "torch": torch.__version__,
        "inputs": ["left", "right"],
        "output": "negative_disparity_nhwc",
    }
    out.with_suffix(out.suffix + ".json").write_text(json.dumps(meta, indent=2))
    return out


def load_exported(path):
    """The saved program (``torch.export.load``); ``.module()(left,
    right)`` runs it."""
    return torch.export.load(Path(path))


class _FixedShape:
    """Calls ``run`` on inputs of one shape and dtype; raises on others."""

    def __init__(self, run, example: torch.Tensor):
        self._run, self.shape, self.dtype = run, tuple(example.shape), example.dtype

    def __call__(self, left, right):
        for t in (left, right):
            if tuple(t.shape) != self.shape or t.dtype != self.dtype:
                raise ValueError(
                    f"compiled for {self.shape} {self.dtype}, got "
                    f"{tuple(t.shape)} {t.dtype}")
        with torch.no_grad():
            return self._run(left, right)


def aot_compile(model, *, image_hw, batch_size: int = 1, dtype=torch.float32,
                device=None):
    """The serving function compiled for one input shape on ``device`` (the
    model's by default): ``f(left, right)`` -> the final map; another shape
    or dtype raises ``ValueError``.

    On a CUDA device the plain forward is captured once in a CUDA graph
    (after a warm-up on a side stream) and each call copies the inputs into
    the graph's buffers, replays it and returns a copy of its output.  On
    the CPU it is the exported program's module."""
    dev = torch.device(device) if device is not None else _device(model)
    model = model.to(dev).eval()
    x = _example(model, image_hw, batch_size, dtype)
    if dev.type != "cuda":
        program = export_program(model, image_hw=image_hw,
                                 batch_size=batch_size, dtype=dtype)
        return _FixedShape(program.module(), x)
    serve = make_serving_fn(model)
    static = [x.clone(), x.clone()]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.no_grad(), torch.cuda.stream(side):
        for _ in range(2):
            serve(*static)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        out = serve(*static)

    def replay(left, right):
        static[0].copy_(left)
        static[1].copy_(right)
        graph.replay()
        return out.clone()

    return _FixedShape(replay, x)
