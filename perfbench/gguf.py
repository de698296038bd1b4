"""A minimal GGUF v3 reader and writer, the benchmark's own.

The harness writes its synthetic weights with ``Writer`` and the plain
reference reads them back with ``Reader``; neither imports the program.
Shapes are in numpy convention and reversed into GGML's ``ne[]`` order on
disk, as gguf-py does. Tensor types: F32, F16, BF16 and I32.
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path

import numpy as np

U32, I32, F32, BOOL, STR, ARR = 4, 5, 6, 7, 8, 9
_SCALAR = {0: "<B", 1: "<b", 2: "<H", 3: "<h", 4: "<I", 5: "<i", 6: "<f", 7: "<?",
           10: "<Q", 11: "<q", 12: "<d"}
T_F32, T_F16, T_I32, T_BF16 = 0, 1, 26, 30
_ELEM_BYTES = {T_F32: 4, T_F16: 2, T_I32: 4, T_BF16: 2}
ALIGN = 32


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns (uint16), rounded to nearest even."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


class Writer:
    """Collects KVs and tensors; ``write`` lays the file out in one pass."""

    def __init__(self, path: str | Path, arch: str):
        self.path = Path(path)
        self._kv: list[bytes] = []
        self._tensors: list[tuple[str, tuple, int, bytes]] = []
        self.add_string("general.architecture", arch)

    def _add(self, key: str, vtype: int, payload: bytes) -> None:
        self._kv.append(_pack_str(key) + struct.pack("<I", vtype) + payload)

    def add_uint32(self, key: str, v: int) -> None:
        self._add(key, U32, struct.pack("<I", int(v)))

    def add_float32(self, key: str, v: float) -> None:
        self._add(key, F32, struct.pack("<f", float(v)))

    def add_bool(self, key: str, v: bool) -> None:
        self._add(key, BOOL, struct.pack("<?", bool(v)))

    def add_string(self, key: str, v: str) -> None:
        self._add(key, STR, _pack_str(v))

    def add_array_i32(self, key: str, vals: list[int]) -> None:
        self._add(key, ARR, struct.pack("<IQ", I32, len(vals)) + struct.pack(f"<{len(vals)}i", *vals))

    def add_array_str(self, key: str, vals: list[str]) -> None:
        self._add(key, ARR, struct.pack("<IQ", STR, len(vals)) + b"".join(_pack_str(v) for v in vals))

    def add_tensor(self, name: str, arr: np.ndarray, gtype: int | None = None) -> None:
        """``arr`` f32 (written as F32, or as BF16 with ``gtype=T_BF16``), int32,
        or uint16 BF16 bit patterns (written as they are)."""
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.int32:
            gtype, blob = T_I32, arr.tobytes()
        elif arr.dtype == np.uint16:
            gtype, blob = T_BF16, arr.tobytes()
        elif gtype == T_BF16:
            blob = bf16_bits(arr).tobytes()
        else:
            gtype, blob = T_F32, arr.astype(np.float32, copy=False).tobytes()
        self._tensors.append((name, arr.shape, gtype, blob))

    def write(self) -> None:
        head = bytearray(b"GGUF" + struct.pack("<Iqq", 3, len(self._tensors), len(self._kv)))
        for kv in self._kv:
            head += kv
        offset, offsets = 0, []
        for name, shape, gtype, blob in self._tensors:
            ne = tuple(reversed(shape)) or (1,)
            head += _pack_str(name) + struct.pack("<I", len(ne))
            head += b"".join(struct.pack("<Q", d) for d in ne)
            head += struct.pack("<IQ", gtype, offset)
            offsets.append(offset)
            offset += -(-len(blob) // ALIGN) * ALIGN
        start = -(-len(head) // ALIGN) * ALIGN
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "wb") as f:
            f.write(bytes(head) + b"\0" * (start - len(head)))
            pos = 0
            for off, (_, _, _, blob) in zip(offsets, self._tensors):
                f.write(b"\0" * (off - pos))
                f.write(blob)
                pos = off + len(blob)


class Reader:
    """mmap-backed reader: ``kv`` (key -> value) and ``tensor(name)`` as f32
    (BF16/F16 widened exactly) or int32, in numpy convention."""

    def __init__(self, path: str | Path):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 4
        if self._mm[:4] != b"GGUF":
            raise ValueError(f"{path}: not a GGUF file")
        version, n_t, n_kv = self._read("<Iqq")
        if version not in (2, 3):
            raise ValueError(f"{path}: GGUF version {version}")
        self.kv: dict = {}
        for _ in range(n_kv):
            key = self._str()
            self.kv[key] = self._value(self._read("<I")[0])
        self.infos: dict[str, tuple[tuple, int, int]] = {}
        for _ in range(n_t):
            name = self._str()
            nd = self._read("<I")[0]
            ne = self._read(f"<{nd}Q")
            gtype, off = self._read("<IQ")
            self.infos[name] = (tuple(reversed(ne)), gtype, off)
        align = int(self.kv.get("general.alignment", ALIGN))
        self._data = -(-self._pos // align) * align

    def _read(self, fmt: str) -> tuple:
        vals = struct.unpack_from(fmt, self._mm, self._pos)
        self._pos += struct.calcsize(fmt)
        return vals

    def _str(self) -> str:
        n = self._read("<Q")[0]
        s = self._mm[self._pos:self._pos + n].decode("utf-8", errors="replace")
        self._pos += n
        return s

    def _value(self, vtype: int):
        if vtype in _SCALAR:
            return self._read(_SCALAR[vtype])[0]
        if vtype == STR:
            return self._str()
        if vtype == ARR:
            etype, n = self._read("<IQ")
            if etype in _SCALAR:
                return list(self._read("<" + str(n) + _SCALAR[etype][1]))
            return [self._value(etype) for _ in range(n)]
        raise ValueError(f"GGUF kv type {vtype}")

    def has(self, name: str) -> bool:
        return name in self.infos

    def tensor(self, name: str) -> np.ndarray:
        shape, gtype, off = self.infos[name]
        if gtype not in _ELEM_BYTES:
            raise ValueError(f"{name}: GGML type {gtype} is not read here")
        n = int(np.prod(shape)) if shape else 1
        raw = np.frombuffer(self._mm, np.uint8, n * _ELEM_BYTES[gtype], self._data + off)
        if gtype == T_F32:
            out = raw.view(np.float32).copy()
        elif gtype == T_I32:
            out = raw.view(np.int32).copy()
        elif gtype == T_F16:
            out = raw.view(np.float16).astype(np.float32)
        else:
            out = (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        return out.reshape(shape)

    def close(self) -> None:
        self._mm.close()
        self._f.close()

    def __enter__(self) -> "Reader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
