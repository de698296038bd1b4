"""Kernel K1: banded attention in [B*H, T, D] layout.

Wraps ``csrc/banded_attention.cu`` (replaces the Pallas kernel
miotts_tpu/ops/pallas/banded_attention.py::banded_attention_pallas). A CPU
tensor takes the plain version; a CUDA tensor launches the kernel, or
raises on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..attention import banded_attention_plain
from . import build

SOURCE = "miotts_tpu_torch/csrc/banded_attention.cu"
REPLACES = "miotts_tpu/ops/pallas/banded_attention.py:33"

# launches of the CUDA kernel in this process (the plain version and
# refusals do not count); callers may reset it to 0
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load_library().miotts_banded_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def banded_attention_folded_plain(q, k, v, lengths, window: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: q/k/v [BH, T, D], lengths [BH]."""
    return banded_attention_plain(q[:, :, None], k[:, :, None], v[:, :, None],
                                  lengths, window)[:, :, 0]


def banded_attention_folded(q, k, v, lengths, window: int) -> torch.Tensor:
    """q/k/v: [BH, T, D] f32, lengths [BH] int32 -> [BH, T, D] f32."""
    global launches
    if q.device.type == "cpu":
        return banded_attention_folded_plain(q, k, v, lengths, window)
    if q.device.type != "cuda":
        raise ValueError(f"banded attention: unsupported device {q.device}")
    BH, T, D = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape:
            raise ValueError(f"banded attention: {name} shape {tuple(x.shape)} != q {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32 or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"banded attention: {name} must be contiguous f32 on {q.device}")
    if (lengths.dtype != torch.int32 or lengths.device != q.device
            or lengths.shape != (BH,) or not lengths.is_contiguous()):
        raise ValueError(f"banded attention: lengths must be contiguous int32 [{BH}] on {q.device}")
    half = max(0, window // 2)
    if not 0 < BH <= 65535 or T < 1 or D < 1:
        raise ValueError(f"banded attention: unsupported shape [{BH}, {T}, {D}]")
    # a D or window too wide for shared memory makes the launcher's
    # cudaFuncSetAttribute fail, which build.check turns into an error
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                      out.data_ptr(), BH, T, D, half, 1.0 / math.sqrt(D), stream)
    build.check(status, "banded_attention")
    launches += 1
    return out
