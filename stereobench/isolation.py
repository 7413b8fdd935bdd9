"""Keep JAX and the JAX package out of the benchmark's process.

The port's package name begins with the JAX package's, so modules are
judged by their top-level name (the part before the first dot), compared
whole: ``realtime_stereo_matcher_tpu_torch`` is allowed,
``realtime_stereo_matcher_tpu`` is not.
"""

from __future__ import annotations

import importlib.abc
import os
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax",
                       "realtime_stereo_matcher_tpu"})


def top_level(name: str) -> str:
    return name.partition(".")[0]


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules`` by
    default)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & FORBIDDEN)


class _Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if top_level(fullname) in FORBIDDEN:
            raise ImportError(f"the benchmark does not load {fullname!r}")
        return None


def block() -> None:
    """Refuse every later import of a forbidden module in this process, and
    ask libraries that load JAX on their own not to."""
    if not any(isinstance(f, _Blocker) for f in sys.meta_path):
        sys.meta_path.insert(0, _Blocker())
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
