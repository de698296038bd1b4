"""Build the native host runtime's library (miotts_tpu/runtime/build_native.py).

    python -m miotts_tpu_torch.runtime.build_native

``runtime/native/miotts_runtime.cpp`` is compiled with the JAX package's flags
(``g++ -O3 -fPIC -shared -std=c++17 -pthread -march=native``) into
``build/miotts_tpu_torch/`` beside the CUDA kernels, never next to the
sources, under a name that hashes the sources (the .cpp and the mp3
decoder's ``mp3_tables.h``, which it includes), the flags and the host's
instruction set: an unchanged tree on the same CPU reuses its library, a
changed one builds anew (as ``ops/cuda/build.py`` does). ``runtime/native.py`` builds it at first use.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

from ..ops.cuda.build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "native" / "miotts_runtime.cpp"
HEADERS = (SRC.parent / "mp3_tables.h",)  # included by SRC: part of the hash
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-march=native")

_lock = threading.Lock()


def compiler() -> str | None:
    return shutil.which("g++") or shutil.which("clang++")


def _host_isa() -> str:
    """The build host's instruction set as ``-march=native`` sees it: a
    library built on one CPU is not loaded on another (a checkout shared
    between hosts would otherwise risk an illegal instruction)."""
    try:
        flags = next((line for line in Path("/proc/cpuinfo").read_text().splitlines()
                      if line.startswith(("flags", "Features"))), "")
    except OSError:
        flags = ""
    return f"{platform.machine()}|{flags}"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_host_isa().encode())
    for src in (SRC, *HEADERS):
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmiotts_runtime_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library for the current source, compiled unless it exists.
    Raises RuntimeError when there is no compiler or the build fails."""
    out = library_path()
    with _lock:
        if out.exists():
            return out
        cxx = compiler()
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++ or clang++) on PATH")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            lib = Path(tmpdir) / out.name
            proc = subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(lib)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(lib, out)  # atomic: a concurrent build loads one or the other
    return out


if __name__ == "__main__":
    try:
        print(f"built {build()}")
    except RuntimeError as e:
        print(e, file=sys.stderr)
        raise SystemExit(1)
