"""ctypes bindings for the port's native host runtime
(miotts_tpu/runtime/native.py), with numpy in its callers when it is absent.

The library is the port's copy of the JAX package's
``runtime/native/miotts_runtime.cpp`` (ABI 6), built at first use by
``runtime/build_native.py``. Its entry points, each bound with JAX's
signature and return convention:

- ``dequantize_native`` (``mio_dequant``): the threaded whole-tensor GGUF
  dequant of F32/F16/BF16/Q8_0/Q4_0/Q6_K to f32, which
  ``gguf/quants.py dequantize`` takes for every non-F32 tensor of at least
  2^16 elements;
- ``encode_wav16_native`` (``mio_encode_wav16``): a whole mono 16-bit WAV
  from f32 audio, ``runtime/audio_io.py encode_wav16``'s first choice;
- ``resample_linear_native`` (``mio_resample_linear[_len]``): the linear
  resampler (no caller in either package; held to ``resample_linear``);
- ``flac_decode_native`` (``mio_flac_probe``, ``mio_flac_decode``): a FLAC
  stream to f32 mono, ``load_audio``'s first choice for a FLAC file;
- ``mp3_decode_native`` (``mio_mp3_probe``, ``mio_mp3_decode``): an
  MPEG-1/2/2.5 Layer III stream to f32 mono, ``load_audio``'s first choice
  for an mp3 file, bit-equal to ``runtime/mp3.py`` (a leading Xing/Info/
  VBRI frame skipped by both); on by default, ``MIOTTS_NATIVE_MP3=0``
  turns it off (JAX's default is off, over a crash that its later notes
  traced to XLA's compile cache, which the port's process does not have);
- ``Q8Gemv`` / ``Q4Gemv`` / ``q8_row_dequant`` / ``q4_row_dequant``: the
  native int8/int4 CPU LLM engine's block-quant GEMVs and GEMMs
  (``models/llm_cpu.py``).

The public functions return None when the library is unavailable, the
type is unsupported or the stream fails to parse; their callers then take
numpy, which gives the same values. ``calls`` counts, by C entry point,
the dequants, WAV encodes, resamples, FLAC and mp3 probes and decodes the
library answered (not the engine's GEMVs, hundreds a token), and
``unavailable_reason`` says why it is not loaded, so a caller can tell
which route a value took.

The library is loaded with ctypes' default ``RTLD_LOCAL``, so it and the
JAX package's ``libmiotts_runtime.so`` (whose ``mio_*`` symbols have the
same names) can live in one process, each with its own worker pool.
``MIOTTS_NO_NATIVE`` set to anything keeps it unloaded. Calls release the
GIL (ctypes does), and each call allocates its own scratch, so threads may
share one matrix.
"""

from __future__ import annotations

import ctypes
import os
import threading
from collections import Counter

import numpy as np

from ..gguf.quants import (  # noqa: F401 (the quantizers are re-exported)
    GGML_TYPE_TRAITS, q4_quantize_weights, q8_quantize_weights)
from .build_native import build

# GGML types the native dequant supports (ids match gguf.quants.GGMLType)
NATIVE_DEQUANT_TYPES = {0, 1, 2, 8, 14, 30}
ABI = 6  # the lowest library version these bindings take

calls: Counter = Counter()  # C entry point -> calls the library answered
_calls_lock = threading.Lock()
_lib = None
_tried = False
_reason = ""
_lock = threading.Lock()
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _bind(lib) -> None:
    lib.mio_runtime_abi_version.restype = _INT
    lib.mio_dequant.restype = _INT
    lib.mio_dequant.argtypes = [_INT, _P, _P, _I64, _INT]
    lib.mio_encode_wav16.restype = _INT
    lib.mio_encode_wav16.argtypes = [_P, _I64, _INT, _P]
    lib.mio_resample_linear.restype = _INT
    lib.mio_resample_linear.argtypes = [_P, _I64, _INT, _INT, _P, _I64]
    lib.mio_resample_linear_len.restype = _I64
    lib.mio_resample_linear_len.argtypes = [_I64, _INT, _INT]
    lib.mio_flac_probe.restype = _INT
    lib.mio_flac_probe.argtypes = [_P, _I64, _P]
    lib.mio_flac_decode.restype = _INT
    lib.mio_flac_decode.argtypes = [_P, _I64, _P, _I64, _P]
    lib.mio_mp3_probe.restype = _INT
    lib.mio_mp3_probe.argtypes = [_P, _I64, _P]
    lib.mio_mp3_decode.restype = _INT
    lib.mio_mp3_decode.argtypes = [_P, _I64, _P, _I64, _P]
    lib.mio_q8_quantize_act.argtypes = [_P, _I64, _P, _P]
    for f in (lib.mio_q8_gemv, lib.mio_q4_gemv):
        f.argtypes = [_P, _P, _P, _I64, _I64, _P, _INT]
    for f in (lib.mio_q8_gemv_f32, lib.mio_q4_gemv_f32):
        f.argtypes = [_P, _P, _I64, _I64, _P, _P, _P, _INT]
    for f in (lib.mio_q8_gemm_f32, lib.mio_q4_gemm_f32):
        f.argtypes = [_P, _P, _I64, _I64, _I64, _P, _P, _P, _INT]
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
            if lib.mio_runtime_abi_version() < ABI:
                raise RuntimeError(f"ABI {lib.mio_runtime_abi_version()} < {ABI}")
        except (OSError, RuntimeError) as e:
            _reason = f"the native library did not build or load: {e}"
            return None
        _lib = lib
    return _lib


def _count(entry: str) -> None:
    with _calls_lock:
        calls[entry] += 1


def unavailable_reason() -> str:
    """Why the library is not loaded ("" when it is, or was never asked for)."""
    return _reason


def available() -> bool:
    return _load() is not None


def dequantize_native(raw: np.ndarray, ggml_type: int, n_elements: int,
                      n_threads: int = 0) -> np.ndarray | None:
    """Threaded native dequantization to flat f32; None if unavailable, the
    type is unsupported, or ``raw`` holds fewer bytes than ``n_elements``
    need (numpy then answers as it would)."""
    lib = _load()
    if lib is None or int(ggml_type) not in NATIVE_DEQUANT_TYPES:
        return None
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    raw = np.ascontiguousarray(raw)
    block, nbytes = GGML_TYPE_TRAITS[int(ggml_type)]
    if raw.nbytes < -(-n_elements // block) * nbytes:
        return None
    out = np.empty(n_elements, np.float32)
    rc = lib.mio_dequant(int(ggml_type), raw.ctypes.data, out.ctypes.data, n_elements,
                         n_threads)
    if rc != 0:
        return None
    _count("mio_dequant")
    return out


def encode_wav16_native(audio: np.ndarray, sample_rate: int) -> bytes | None:
    """A whole mono 16-bit WAV (header + PCM clamped to [-1, 1], rounded to
    nearest even at 32767 scale); None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, np.float32)
    out = np.empty(44 + 2 * audio.size, np.uint8)
    if lib.mio_encode_wav16(audio.ctypes.data, audio.size, sample_rate, out.ctypes.data) != 0:
        return None
    _count("mio_encode_wav16")
    return out.tobytes()


def resample_linear_native(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray | None:
    """The linear resampler in f64 positions and weights; ``x`` itself for
    an empty input or equal rates; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    if x.size == 0 or sr_in == sr_out:
        return x
    n_out = lib.mio_resample_linear_len(x.size, sr_in, sr_out)
    out = np.empty(n_out, np.float32)
    if lib.mio_resample_linear(x.ctypes.data, x.size, sr_in, sr_out, out.ctypes.data,
                               n_out) != 0:
        return None
    _count("mio_resample_linear")
    return out


def flac_decode_native(data: bytes) -> tuple[np.ndarray, int] | None:
    """A FLAC stream -> (f32 mono, rate): the channels' mean scaled by
    2^-(bps-1); None if the library is unavailable or the stream fails to
    parse (callers fall back to ``runtime/flac.py``). A stream whose
    STREAMINFO gives no sample count decodes into a buffer grown 4x and
    retried, up to 8 times."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int64)
    if lib.mio_flac_probe(buf.ctypes.data, buf.size, info.ctypes.data) != 0:
        return None
    channels = int(info[1])
    cap = int(info[3]) or max(4096, buf.size * 4 // max(1, channels))
    for _ in range(8):
        out = np.empty(cap * channels, np.int32)
        rc = lib.mio_flac_decode(buf.ctypes.data, buf.size, out.ctypes.data, cap,
                                 info.ctypes.data)
        if rc == 0:
            n, rate, bps = int(info[3]), int(info[0]), int(info[2])
            x = out[: n * channels].reshape(n, channels).mean(axis=1)
            _count("mio_flac_decode")
            return (x / float(1 << (bps - 1))).astype(np.float32), rate
        if rc != -2:
            return None
        cap *= 4
    return None


def mp3_decode_native(data: bytes) -> tuple[np.ndarray, int] | None:
    """An MPEG-1/2/2.5 Layer III stream -> (f32 mono in [-1, 1], rate),
    bit-equal to ``runtime/mp3.py decode_mp3``; None under
    MIOTTS_NATIVE_MP3=0, if the library is unavailable or if no frame
    decodes (callers fall back to ``runtime/mp3.py``). The probe's sample
    estimate sizes the buffer; a decode that fills it grows it 4x and
    retries, up to 8 times."""
    if os.environ.get("MIOTTS_NATIVE_MP3", "1") == "0":
        return None
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int64)
    if lib.mio_mp3_probe(buf.ctypes.data, buf.size, info.ctypes.data) != 0:
        return None
    _count("mio_mp3_probe")
    cap = int(info[2]) or max(4096, buf.size * 16)
    for _ in range(8):
        out = np.empty(cap, np.float32)
        rc = lib.mio_mp3_decode(buf.ctypes.data, buf.size, out.ctypes.data, cap,
                                info.ctypes.data)
        if rc == 0:
            _count("mio_mp3_decode")
            return out[: int(info[1])].copy(), int(info[0])
        if rc != -2:
            return None
        cap *= 4
    return None


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
