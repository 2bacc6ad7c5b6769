"""Build-and-dlopen helper for the port's host C++ bindings (``io/aio.py``;
a copy of ``deepspeed_tpu/utils/ctypes_build.py``).

Build the shared library with ``g++`` from source when it is missing or
stale, then dlopen it.  Two hardenings every caller needs:

- temp path + atomic rename: concurrent builders racing the same ``-o``
  target cannot CDLL a half-written .so;
- rebuild-once on dlopen failure: a library left by another toolchain
  raises OSError from CDLL but rebuilds from source in seconds.

The libraries go to ``build/deepspeed_tpu_torch/host/`` at the root of the
checkout (``build/`` is git-ignored), at first use.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

HOST_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
                  / "deepspeed_tpu_torch" / "host")


def load_or_build(lib_path: str, src_path: str,
                  extra_flags: Sequence[str] = ()
                  ) -> Optional[ctypes.CDLL]:
    """Return the dlopened library, building or rebuilding as needed; None
    when there is no toolchain (or no loadable artifact)."""
    def build():
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", *extra_flags, "-shared", "-fPIC", "-o", tmp,
             src_path, "-lpthread"],
            check=True, capture_output=True)
        os.replace(tmp, lib_path)

    if not os.path.exists(lib_path) or (
            os.path.exists(src_path)
            and os.path.getmtime(src_path) > os.path.getmtime(lib_path)):
        try:
            build()
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
    try:
        return ctypes.CDLL(lib_path)
    except OSError:
        try:
            build()
            return ctypes.CDLL(lib_path)
        except (subprocess.CalledProcessError, FileNotFoundError,
                OSError):
            return None
