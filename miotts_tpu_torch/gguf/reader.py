"""mmap-based GGUF v2/v3 reader (miotts_tpu/gguf/reader.py).

GGUF layout: header (magic/version/counts), KV metadata, tensor infos, then
an aligned data section. Dimensions in tensor infos are GGML ``ne[]`` order
(ne[0] = fastest-varying); numpy tensors written by gguf-py have their shape
reversed into ne[] — ``GGUFReader.tensor()`` reverses back, so tensors load
in the original (torch/numpy) convention: Linear weights are [out, in],
Conv1d weights are [out, in, k], ConvTranspose1d weights are [in, out, k].

Parity notes: replaces gguf C API reads in the reference
(``miocodec-decoder.cpp:392-497``, ``wavlm-extractor.cpp:445-488``,
``mio-tts-lib.cpp:349-413``).
"""

from __future__ import annotations

import dataclasses
import mmap
import struct
from pathlib import Path

import numpy as np

from .quants import GGML_TYPE_TRAITS, GGMLType, dequantize, type_nbytes

GGUF_MAGIC = b"GGUF"

# GGUF metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, _T_STR, _T_ARR, _T_U64, _T_I64, _T_F64 = range(13)

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_BOOL: "<?",
    _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d",
}


@dataclasses.dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]  # numpy/torch convention (ne[] reversed)
    ggml_type: GGMLType
    offset: int  # relative to data section start

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


class GGUFReader:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 0
        self.kv: dict[str, object] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        self._parse()

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self) -> "GGUFReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- low-level readers ---------------------------------------------------

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self._mm, self._pos)
        self._pos += size
        return vals[0] if len(vals) == 1 else vals

    def _read_str(self) -> str:
        n = self._read("<Q")
        s = self._mm[self._pos:self._pos + n]
        self._pos += n
        return s.decode("utf-8", errors="replace")

    def _read_value(self, vtype: int):
        if vtype in _SCALAR_FMT:
            return self._read(_SCALAR_FMT[vtype])
        if vtype == _T_STR:
            return self._read_str()
        if vtype == _T_ARR:
            etype = self._read("<I")
            count = self._read("<Q")
            if etype in _SCALAR_FMT:
                fmt = "<" + str(count) + _SCALAR_FMT[etype][1]
                vals = struct.unpack_from(fmt, self._mm, self._pos)
                self._pos += struct.calcsize(fmt)
                return list(vals)
            return [self._read_value(etype) for _ in range(count)]
        raise ValueError(f"unknown GGUF kv type {vtype}")

    # -- parse ----------------------------------------------------------------

    def _parse(self) -> None:
        magic = self._mm[0:4]
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic={magic!r})")
        self._pos = 4
        self.version = self._read("<I")
        if self.version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = self._read("<q")
        n_kv = self._read("<q")

        for _ in range(n_kv):
            key = self._read_str()
            vtype = self._read("<I")
            self.kv[key] = self._read_value(vtype)
        # byte span of the serialized KV section (starts right after the
        # 24-byte header) — lets tools rewrite tensor payloads while copying
        # the metadata verbatim (convert/quantize.py)
        self.n_kv = n_kv
        self.kv_end = self._pos

        infos = []
        for _ in range(n_tensors):
            name = self._read_str()
            n_dims = self._read("<I")
            ne = [self._read("<Q") for _ in range(n_dims)]
            ggml_type = GGMLType(self._read("<I"))
            offset = self._read("<Q")
            # ne[] order -> numpy convention
            infos.append(GGUFTensorInfo(name, tuple(reversed(ne)), ggml_type, offset))

        self.alignment = int(self.kv.get("general.alignment", 32))
        self.data_offset = (self._pos + self.alignment - 1) // self.alignment * self.alignment
        for info in infos:
            self.tensors[info.name] = info

    # -- tensor access ---------------------------------------------------------

    def tensor_raw(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        nbytes = type_nbytes(info.ggml_type, info.n_elements)
        start = self.data_offset + info.offset
        return np.frombuffer(self._mm, dtype=np.uint8, count=nbytes, offset=start)

    def tensor(self, name: str, dtype=np.float32) -> np.ndarray:
        """Load + dequantize a tensor in numpy/torch-convention shape."""
        info = self.tensors[name]
        flat = dequantize(self.tensor_raw(name), info.ggml_type, info.n_elements)
        arr = flat.reshape(info.shape)
        if dtype is not None and not np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(dtype, copy=True)
        else:
            arr = np.array(arr)  # detach from the mmap so close() stays valid
        return arr

    def has_tensor(self, name: str) -> bool:
        return name in self.tensors

    # typed KV accessors mirroring get_u32_kv/get_f32_kv (miocodec-decoder.cpp:356-390)
    def get_u32(self, key: str, default: int | None = None) -> int | None:
        v = self.kv.get(key)
        return int(v) if v is not None else default

    def get_f32(self, key: str, default: float | None = None) -> float | None:
        v = self.kv.get(key)
        return float(v) if v is not None else default

    def get_str(self, key: str, default: str | None = None) -> str | None:
        v = self.kv.get(key)
        return str(v) if v is not None else default
