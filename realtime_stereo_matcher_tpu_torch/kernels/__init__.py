"""Hand-written CUDA kernels of the port and the plans that feed them.

Nothing is compiled when this package is imported: the first launch builds
``csrc/*.cu`` (see ``_build.py``).  ``LAUNCHES`` counts launches per kernel.
"""

from realtime_stereo_matcher_tpu_torch.kernels._build import LAUNCHES

__all__ = ["LAUNCHES"]
