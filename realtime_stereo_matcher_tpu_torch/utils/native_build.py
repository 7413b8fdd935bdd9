"""On-demand g++ build of the port's host C++ (port of
``realtime_stereo_matcher_tpu/utils/native_build.py``).

A source of ``native/`` is compiled into a shared object under
``realtime_stereo_matcher_tpu_torch/_build/`` (gitignored), named by a hash
of the source and the flags, at its first use and never at import; a later
call finds it there.  ``-march=native`` tunes it to the machine that builds
it, which is the machine that runs it.  A failed build raises with g++'s
output: nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PACKAGE / "native"
BUILD_DIR = _PACKAGE / "_build"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
            "-funroll-loops"]
_LOCK = threading.Lock()


def build_native(source_name: str) -> Path:
    """Compile ``native/<source_name>`` into a cached shared object and
    return its path."""
    src = NATIVE_DIR / source_name
    code = src.read_bytes()
    tag = hashlib.sha256(code + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{tag}.so"
    if out.exists():
        return out
    with _LOCK:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *CXXFLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed for {source_name}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out
