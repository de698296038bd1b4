"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``miotts_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process for Hopper (``sm_90a``), all started together, and the objects are
linked into ONE shared library with a plain C interface, under
``build/miotts_tpu_torch/`` beside the package, named by a hash of the
sources and flags: an unchanged tree reuses its library, a changed one
builds anew. No PyTorch header is included, which keeps a build to seconds
(``torch.utils.cpp_extension.load`` takes minutes for the same sources).

Wrappers bind each C entry point with ``ctypes.c_void_p`` for every pointer
and the stream; each entry point returns ``cudaGetLastError()`` after its
launch, and the wrapper raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "miotts_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(defines: tuple[str, ...] = ()) -> Path:
    """Where the library for the current sources (and macros) lives."""
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmiotts_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, defines: tuple[str, ...] = ()) -> Path:
    """Compile the kernels unless a library for these sources exists: one
    ``nvcc -c`` per source, run in parallel, then one link. ``defines``
    are macros for a measuring build (a library of its own; the wrappers
    load the plain one). Raises RuntimeError with nvcc's stderr when a step
    fails."""
    flags = _flags(defines)
    out = library_path(defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = Path(tmpdir) / f"{src.stem}.o"
            cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
            if verbose:
                cmd.insert(1, "--ptxas-options=-v")
            objs.append(str(obj))
            procs.append((src.name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{err}")
            elif verbose and err:
                print(err, end="")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        lib = Path(tmpdir) / out.name
        proc = subprocess.run([nvcc, *flags, "-shared", "-o", str(lib), *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' library, built if needed; loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def launch(device, entry, *args) -> int:
    """Call a kernel's C entry point with ``device`` (a CUDA device of the
    kernel's tensors) current: the launch, and the shared-memory limit it
    may raise first, concern the current device, which on a mesh need not
    be the tensors' own. Returns its status."""
    import torch

    with torch.cuda.device(device):
        return entry(*args)


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")
