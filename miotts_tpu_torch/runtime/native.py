"""ctypes bindings for the native CPU LLM engine's kernels
(miotts_tpu/runtime/native.py, its int8/int4 half).

The library is the port's copy of the JAX package's block-quant GEMVs
(``runtime/native/miotts_gemv.cpp``), built at first use by
``runtime/build_native.py``. It is loaded with ctypes' default
``RTLD_LOCAL``, so it and the JAX package's ``libmiotts_runtime.so`` (whose
``mio_*`` symbols have the same names) can live in one process, each with
its own worker pool. ``MIOTTS_NO_NATIVE`` set to anything keeps it
unloaded; ``unavailable_reason`` says why it is not there.

Calls release the GIL (ctypes does), and each call allocates its own
activation scratch, so threads may share one matrix.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..gguf.quants import q4_quantize_weights, q8_quantize_weights  # noqa: F401 (re-exported)
from .build_native import build

_lib = None
_tried = False
_reason = ""
_lock = threading.Lock()
_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def _bind(lib) -> None:
    lib.mio_runtime_abi_version.restype = ctypes.c_int
    lib.mio_q8_quantize_act.argtypes = [_P, _I64, _P, _P]
    for f in (lib.mio_q8_gemv, lib.mio_q4_gemv):
        f.argtypes = [_P, _P, _P, _I64, _I64, _P, ctypes.c_int]
    for f in (lib.mio_q8_gemv_f32, lib.mio_q4_gemv_f32):
        f.argtypes = [_P, _P, _I64, _I64, _P, _P, _P, ctypes.c_int]
    for f in (lib.mio_q8_gemm_f32, lib.mio_q4_gemm_f32):
        f.argtypes = [_P, _P, _I64, _I64, _I64, _P, _P, _P, ctypes.c_int]
    for f in (lib.mio_q8_row_dequant, lib.mio_q4_row_dequant):
        f.argtypes = [_P, _I64, _I64, _P]
    for f in (lib.mio_q8_quantize_act, lib.mio_q8_gemv, lib.mio_q4_gemv, lib.mio_q8_gemv_f32,
              lib.mio_q4_gemv_f32, lib.mio_q8_gemm_f32, lib.mio_q4_gemm_f32,
              lib.mio_q8_row_dequant, lib.mio_q4_row_dequant):
        f.restype = None


def _load():
    """The library, built and loaded once a process; None when unavailable."""
    global _lib, _tried, _reason
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MIOTTS_NO_NATIVE"):
            _reason = "MIOTTS_NO_NATIVE is set"
            return None
        try:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            if lib.mio_runtime_abi_version() < 4:
                raise RuntimeError(f"ABI {lib.mio_runtime_abi_version()} < 4")
        except (OSError, RuntimeError) as e:
            _reason = f"the native library did not build or load: {e}"
            return None
        _lib = lib
    return _lib


def unavailable_reason() -> str:
    """Why the library is not loaded ("" when it is, or was never asked for)."""
    return _reason


def q8_available() -> bool:
    return _load() is not None


def q4_available() -> bool:
    return _load() is not None


class _BlockGemv:
    """One block-quant weight matrix [N, K] (raw GGUF block bytes, rows
    K-contiguous); y = W @ x a call."""

    BLOCK_BYTES = 0
    _gemv = _gemm = ""

    def __init__(self, raw: np.ndarray, n: int, k: int):
        assert k % 32 == 0, k
        self.raw = np.ascontiguousarray(raw.reshape(-1).view(np.uint8))
        assert self.raw.size == n * (k // 32) * self.BLOCK_BYTES, (self.raw.size, n, k)
        self.n = n
        self.k = k

    def __call__(self, x: np.ndarray, out: np.ndarray | None = None,
                 n_threads: int = 1) -> np.ndarray:
        lib = _load()
        x = np.ascontiguousarray(x, np.float32)
        y = out if out is not None else np.empty(self.n, np.float32)
        q = np.empty(self.k, np.int8)
        s = np.empty(self.k // 32, np.float32)
        getattr(lib, self._gemv)(self.raw.ctypes.data, x.ctypes.data, self.n, self.k,
                                 y.ctypes.data, q.ctypes.data, s.ctypes.data, n_threads)
        return y

    def gemm(self, x: np.ndarray, n_threads: int = 1) -> np.ndarray:
        """[B, K] @ W^T -> [B, N], each weight row read once for all B rows
        (the batched prompt prefill)."""
        lib = _load()
        x = np.ascontiguousarray(x, np.float32)
        batch = x.shape[0]
        y = np.empty((batch, self.n), np.float32)
        q = np.empty(batch * self.k, np.int8)
        s = np.empty(batch * (self.k // 32), np.float32)
        getattr(lib, self._gemm)(self.raw.ctypes.data, x.ctypes.data, self.n, self.k, batch,
                                 y.ctypes.data, q.ctypes.data, s.ctypes.data, n_threads)
        return y


class Q8Gemv(_BlockGemv):
    """Q8_0 blocks: an f16 scale and 32 int8 values."""
    BLOCK_BYTES = 34
    _gemv, _gemm = "mio_q8_gemv_f32", "mio_q8_gemm_f32"


class Q4Gemv(_BlockGemv):
    """Q4_0 blocks: an f16 scale and 16 bytes of nibbles (W4A8: half the
    weight bytes of Q8_0)."""
    BLOCK_BYTES = 18
    _gemv, _gemm = "mio_q4_gemv_f32", "mio_q4_gemm_f32"


def q8_row_dequant(raw: np.ndarray, row: int, k: int) -> np.ndarray:
    out = np.empty(k, np.float32)
    _load().mio_q8_row_dequant(raw.ctypes.data, row, k, out.ctypes.data)
    return out


def q4_row_dequant(raw: np.ndarray, row: int, k: int) -> np.ndarray:
    out = np.empty(k, np.float32)
    _load().mio_q4_row_dequant(raw.ctypes.data, row, k, out.ctypes.data)
    return out
