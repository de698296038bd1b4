"""Minimal GGUF v3 writer (miotts_tpu/gguf/writer.py).

Used for speaker-embedding artifacts (``*.emb.gguf``) with the exact layout
the reference emits/consumes (``mio-tts-lib.cpp:288-347``: arch
"mio-embedding", KV ``mio.embedding.dim``, f32 tensor
``mio.global_embedding``), and for writing synthetic test-model GGUFs.

Tensors are passed in numpy convention; shapes are reversed into GGML ne[]
order on disk (matching gguf-py's behavior, so our reader and GGML's loader
both see the right layout).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .quants import GGMLType, q4_quantize_weights, q8_quantize_weights

_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, _T_STR, _T_ARR, _T_U64, _T_I64, _T_F64 = range(13)

_NP_TO_GGML = {
    np.dtype(np.float32): GGMLType.F32,
    np.dtype(np.float16): GGMLType.F16,
    np.dtype(np.int32): GGMLType.I32,
    np.dtype(np.int16): GGMLType.I16,
    np.dtype(np.int8): GGMLType.I8,
    np.dtype(np.int64): GGMLType.I64,
    np.dtype(np.float64): GGMLType.F64,
}


class GGUFWriter:
    def __init__(self, path: str | Path, arch: str):
        self.path = Path(path)
        self.alignment = 32
        self._kv: list[bytes] = []
        self._tensors: list[tuple[str, np.ndarray, GGMLType]] = []
        self.add_string("general.architecture", arch)

    # -- KV ---------------------------------------------------------------

    @staticmethod
    def _pack_str(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def _add_kv(self, key: str, vtype: int, payload: bytes) -> None:
        self._kv.append(self._pack_str(key) + struct.pack("<I", vtype) + payload)

    def add_uint32(self, key: str, value: int) -> None:
        self._add_kv(key, _T_U32, struct.pack("<I", value))

    def add_int32(self, key: str, value: int) -> None:
        self._add_kv(key, _T_I32, struct.pack("<i", value))

    def add_float32(self, key: str, value: float) -> None:
        self._add_kv(key, _T_F32, struct.pack("<f", value))

    def add_bool(self, key: str, value: bool) -> None:
        self._add_kv(key, _T_BOOL, struct.pack("<?", value))

    def add_string(self, key: str, value: str) -> None:
        self._add_kv(key, _T_STR, self._pack_str(value))

    def add_array_i32(self, key: str, values: list[int]) -> None:
        payload = struct.pack("<IQ", _T_I32, len(values))
        payload += struct.pack(f"<{len(values)}i", *values)
        self._add_kv(key, _T_ARR, payload)

    def add_array_str(self, key: str, values: list[str]) -> None:
        payload = struct.pack("<IQ", _T_STR, len(values))
        payload += b"".join(self._pack_str(v) for v in values)
        self._add_kv(key, _T_ARR, payload)

    def add_array_f32(self, key: str, values: list[float]) -> None:
        payload = struct.pack("<IQ", _T_F32, len(values))
        payload += struct.pack(f"<{len(values)}f", *values)
        self._add_kv(key, _T_ARR, payload)

    # -- tensors ------------------------------------------------------------

    def add_tensor(self, name: str, array: np.ndarray) -> None:
        arr = np.ascontiguousarray(array)
        ggml_type = _NP_TO_GGML.get(arr.dtype)
        if ggml_type is None:
            arr = arr.astype(np.float32)
            ggml_type = GGMLType.F32
        self._tensors.append((name, arr, ggml_type))

    def add_tensor_q8_0(self, name: str, array: np.ndarray) -> None:
        """Write a 2-D f32 weight as Q8_0 blocks (the shipped
        MioTTS-0.1B-Q8_0 storage; llama.cpp block layout: per-32 f16 scale
        + 32 int8). Logical shape is preserved in the tensor info; the
        payload is the packed block bytes."""
        arr = np.ascontiguousarray(array, np.float32)
        assert arr.ndim == 2 and arr.shape[1] % 32 == 0, arr.shape
        raw = q8_quantize_weights(arr)

        class _Q8Blob:
            shape = arr.shape
            ndim = 2

            @staticmethod
            def tobytes() -> bytes:
                return raw.tobytes()

        self._tensors.append((name, _Q8Blob, GGMLType.Q8_0))

    def add_tensor_q4_0(self, name: str, array: np.ndarray) -> None:
        """Write a 2-D f32 weight as Q4_0 blocks (the standard llama.cpp
        4-bit export: per-32 f16 scale + 16 nibble bytes, +8 bias)."""
        arr = np.ascontiguousarray(array, np.float32)
        assert arr.ndim == 2 and arr.shape[1] % 32 == 0, arr.shape
        raw = q4_quantize_weights(arr)

        class _Q4Blob:
            shape = arr.shape
            ndim = 2

            @staticmethod
            def tobytes() -> bytes:
                return raw.tobytes()

        self._tensors.append((name, _Q4Blob, GGMLType.Q4_0))

    # -- write ----------------------------------------------------------------

    def write(self) -> None:
        align = self.alignment
        out = bytearray()
        out += b"GGUF"
        out += struct.pack("<I", 3)
        out += struct.pack("<q", len(self._tensors))
        out += struct.pack("<q", len(self._kv))
        for kv in self._kv:
            out += kv

        # tensor infos with running aligned offsets
        offset = 0
        data_blobs: list[tuple[int, bytes]] = []
        for name, arr, ggml_type in self._tensors:
            ne = tuple(reversed(arr.shape)) if arr.ndim > 0 else (1,)
            out += self._pack_str(name)
            out += struct.pack("<I", len(ne))
            for d in ne:
                out += struct.pack("<Q", d)
            out += struct.pack("<I", int(ggml_type))
            out += struct.pack("<Q", offset)
            blob = arr.tobytes()
            data_blobs.append((offset, blob))
            offset += (len(blob) + align - 1) // align * align

        data_start = (len(out) + align - 1) // align * align
        out += b"\0" * (data_start - len(out))
        for off, blob in data_blobs:
            pos = data_start + off
            if len(out) < pos:
                out += b"\0" * (pos - len(out))
            out += blob

        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_bytes(bytes(out))


def save_embedding_gguf(path: str | Path, embedding: np.ndarray) -> None:
    """Write a speaker embedding exactly like save_embedding_gguf_vec
    (mio-tts-lib.cpp:288-347)."""
    emb = np.asarray(embedding, dtype=np.float32).reshape(-1)
    if emb.size == 0:
        raise ValueError("embedding is empty")
    w = GGUFWriter(path, arch="mio-embedding")
    w.add_string("general.type", "embedding")
    w.add_uint32("mio.embedding.dim", emb.size)
    w.add_tensor("mio.global_embedding", emb)
    w.write()


def load_embedding_gguf(path: str | Path) -> np.ndarray:
    """Read a speaker embedding like load_embedding_gguf_vec
    (mio-tts-lib.cpp:349-413): prefer tensor 'mio.global_embedding',
    fall back to a sole tensor."""
    from .reader import GGUFReader

    with GGUFReader(path) as r:
        name = "mio.global_embedding"
        if name not in r.tensors:
            if len(r.tensors) == 1:
                name = next(iter(r.tensors))
            else:
                raise ValueError(f"{path}: missing tensor 'mio.global_embedding'")
        info = r.tensors[name]
        if info.ggml_type != GGMLType.F32:
            raise ValueError(f"{path}: embedding tensor must be f32")
        return np.array(r.tensor(name), dtype=np.float32).reshape(-1)
