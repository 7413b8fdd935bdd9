"""realtime_stereo_matcher_tpu_torch: the stereo matcher in PyTorch and CUDA.

A port of the JAX package ``realtime_stereo_matcher_tpu`` to PyTorch on an
NVIDIA Hopper card.  Module names mirror the JAX package (``ops/``,
``models/``, ``kernels/``) so each module's counterpart is easy to find.  The
convolutions that the JAX package ran as Pallas TPU kernels run here as CUDA
kernels written by hand (``csrc/``, built and bound by ``kernels/_build.py``).
This package imports nothing from JAX or from the JAX package.

Layouts at the public functions are the JAX package's: NHWC for images and
features, (B, D, H, W, C) for cost volumes.

Repo-wide sign convention (inherited from the reference, see
reference dataset/stereo_datasets.py:78 and model/*.py): disparity is
represented as *negative horizontal flow*.  Every model returns negative
disparity maps; evaluation treats ``flow_pr < 0`` as valid.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without CUDA they raise rather than fall back to the CPU.
"""

import functools

import torch

__version__ = "0.1.0"


def stats_dtype(*dtypes: torch.dtype) -> torch.dtype:
    """The type statistics, masked sums and the softmax are taken in for
    inputs of ``dtypes``: float32, or float64 where one is float64 (flax
    promotes to at least float32; float64 steps are compared to rounding)."""
    return functools.reduce(torch.promote_types, dtypes, torch.float32)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for and
    absent (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
