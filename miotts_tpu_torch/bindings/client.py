"""ctypes wrapper over the native mio_tpu_client bridge library
(miotts_tpu/bindings/client.py).

The C library (``bindings/native/mio_tpu_client.{h,cpp}``, the JAX
package's bridge copied) is what a device app links against: a thin HTTP
client of the port's server with the surface of the reference's on-device
bridges (MioTTSLocalBridge.h:11-92, mio_tts_android_jni.cpp:73-425). This
wrapper makes the bridge testable from pytest and usable from Python tools
through the very C ABI an iOS/Android app calls.

The library is built at first use with JAX's flags (``g++ -O2 -fPIC -shared
-std=c++17``) into ``build/miotts_tpu_torch/``, never next to the sources,
under a name that hashes the sources and the flags, so an unchanged tree
reuses it (as ``runtime/build_native.py`` does):

    python -m miotts_tpu_torch.bindings.build_client
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

from ..ops.cuda.build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "native" / "mio_tpu_client.cpp"
_HEADER = _SRC.with_suffix(".h")
_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in (_SRC, _HEADER):
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmio_tpu_client_{h.hexdigest()[:16]}.so"


def build_client_lib(verbose: bool = False) -> Path | None:
    """The bridge library for the current sources, compiled unless it
    exists; None when there is no C++ compiler or the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        if verbose:
            print("no C++ compiler found", file=sys.stderr)
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        lib = Path(tmpdir) / out.name
        proc = subprocess.run([cxx, *_FLAGS, str(_SRC), "-o", str(lib)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            if verbose:
                print(f"client bridge build failed ({proc.returncode}):\n{proc.stderr}",
                      file=sys.stderr)
            return None
        os.replace(lib, out)  # atomic: a concurrent build loads one or the other
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build_client_lib()
        if path is None:
            raise RuntimeError("cannot build libmio_tpu_client (no C++ compiler?)")
        lib = ctypes.CDLL(str(path))
        P, CP, SZ, I32, F = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                             ctypes.c_int32, ctypes.c_float)
        lib.mio_tpu_client_create.restype = P
        lib.mio_tpu_client_create.argtypes = [CP, CP, SZ]
        lib.mio_tpu_client_destroy.argtypes = [P]
        signatures = {
            "mio_tpu_client_set_generation_params": [P, I32, I32, F, F, F, I32, CP, SZ],
            "mio_tpu_client_health_json": [P, ctypes.POINTER(CP), CP, SZ],
            "mio_tpu_client_list_references_json": [P, ctypes.POINTER(CP), CP, SZ],
            "mio_tpu_client_create_reference_from_audio": [P, CP, CP, F, CP, CP, SZ],
            "mio_tpu_client_add_reference_from_gguf": [P, CP, CP, CP, SZ],
            "mio_tpu_client_remove_reference": [P, CP, CP, SZ],
            "mio_tpu_client_synthesize_to_wav": [P, CP, CP, I32, CP, CP, SZ],
            "mio_tpu_client_synthesize_codes_to_wav": [P, ctypes.POINTER(I32), SZ, CP, CP,
                                                       CP, SZ],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_bool
            fn.argtypes = argtypes
        lib.mio_tpu_string_free.argtypes = [CP]
        _lib = lib
        return lib


_ERR_CAP = 512


class MioTPUClient:
    """A device app's connection to a miotts server (one handle of the C bridge)."""

    def __init__(self, base_url: str):
        self._lib = _load()
        err = ctypes.create_string_buffer(_ERR_CAP)
        self._h = self._lib.mio_tpu_client_create(base_url.encode(), err, _ERR_CAP)
        if not self._h:
            raise ConnectionError(err.value.decode() or "client create failed")

    def close(self):
        if getattr(self, "_h", None):
            self._lib.mio_tpu_client_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _call(self, fn, *args) -> None:
        err = ctypes.create_string_buffer(_ERR_CAP)
        if not fn(self._h, *args, err, _ERR_CAP):
            raise RuntimeError(err.value.decode() or "bridge call failed")

    def _json(self, fn) -> str:
        out = ctypes.c_char_p()
        err = ctypes.create_string_buffer(_ERR_CAP)
        if not fn(self._h, ctypes.byref(out), err, _ERR_CAP):
            raise RuntimeError(err.value.decode() or "bridge call failed")
        try:
            return out.value.decode()
        finally:
            self._lib.mio_tpu_string_free(out)

    def set_generation_params(self, n_predict: int = -1, top_k: int = -1,
                              top_p: float = -1.0, temp: float = -1.0,
                              repeat_penalty: float = -1.0, seed: int = -12345678) -> None:
        """Defaults for later synthesize calls; a negative value (the seed's
        sentinel -12345678) leaves that parameter to the server."""
        self._call(self._lib.mio_tpu_client_set_generation_params,
                   n_predict, top_k, top_p, temp, repeat_penalty, seed)

    def health_json(self) -> str:
        return self._json(self._lib.mio_tpu_client_health_json)

    def list_references_json(self) -> str:
        return self._json(self._lib.mio_tpu_client_list_references_json)

    def create_reference_from_audio(self, key: str, audio_path: str,
                                    max_reference_seconds: float = 0.0,
                                    embedding_out_path: str | None = None) -> None:
        """Upload a WAV, FLAC or mp3 file to /mio/generate_reference and
        register the speaker embedding under ``key``; optionally keep the
        returned .emb.gguf at ``embedding_out_path``."""
        self._call(self._lib.mio_tpu_client_create_reference_from_audio,
                   key.encode(), audio_path.encode(), max_reference_seconds,
                   embedding_out_path.encode() if embedding_out_path else None)

    def add_reference_from_gguf(self, key: str, embedding_path: str) -> None:
        self._call(self._lib.mio_tpu_client_add_reference_from_gguf,
                   key.encode(), embedding_path.encode())

    def remove_reference(self, key: str) -> None:
        self._call(self._lib.mio_tpu_client_remove_reference, key.encode())

    def synthesize_to_wav(self, text: str, reference_key: str, output_wav_path: str,
                          n_predict: int = -1) -> None:
        self._call(self._lib.mio_tpu_client_synthesize_to_wav,
                   text.encode(), reference_key.encode(), n_predict,
                   output_wav_path.encode())

    def synthesize_codes_to_wav(self, codes, reference_key: str,
                                output_wav_path: str) -> None:
        arr = (ctypes.c_int32 * len(codes))(*codes)
        self._call(self._lib.mio_tpu_client_synthesize_codes_to_wav,
                   arr, len(codes), reference_key.encode(), output_wav_path.encode())
