"""Pure-Python GGUF reader/writer with numpy dequantization
(miotts_tpu/gguf/).

Replaces the reference's GGML gguf C API usage (load:
``miocodec-decoder.cpp:447-456``, embedding I/O: ``mio-tts-lib.cpp:288-413``)
with an mmap-based reader that yields numpy arrays in *torch convention*
shapes (the converters write numpy row-major tensors; GGML reverses dims into
its ne[] order — we undo that, so a Linear weight reads back as [out, in]).
"""

from .reader import GGUFReader, GGUFTensorInfo
from .writer import GGUFWriter
from .quants import dequantize, GGMLType

__all__ = ["GGUFReader", "GGUFTensorInfo", "GGUFWriter", "dequantize", "GGMLType"]
