"""The codec's matmul precision, ``MIOTTS_CODEC_MATMUL``
(miotts_tpu/models/miocodec.py:452-466, :587).

The JAX package runs the codec trunk (``codec_decode_spec``) and its
synthesis head (the iSTFT's DFT matmul, or the vocoder) under
``jax.default_matmul_precision(MIOTTS_CODEC_MATMUL)``: ``float32`` (the
default), ``tensorfloat32`` or ``bfloat16``; the encoder, WavLM and the
LLM keep their own. The pipeline reads the variable once, when it is
built, and passes the mode down. JAX's context covers one trace on one
thread, while PyTorch's TF32 switches cover the whole process: flipping
them around a codec call would reach a reference chain or an eager decode
that another thread runs meanwhile. So the port leaves them off (``device.select_device``)
and the codec's own matmul and convolution calls take their operands
through ``mm`` and ``operand``, which read the mode of this thread's
innermost ``codec_matmul`` context (``float32`` outside one):

- ``float32`` and ``tensorfloat32``: the operands as they are; the code
  computes what it computes without the context, bit for bit. The card's
  f32 is at least as accurate as TF32, and here it is also faster: TF32
  can only be switched on for the whole process, and emulating its
  rounding in extra elementwise passes took the wave decode 37-43% longer
  on an H100.
- ``bfloat16``: operands rounded to bf16 (to nearest, ties to even),
  products and sums in f32. On the card a matmul is one bf16 cuBLAS GEMM
  with an f32 result (``torch.mm(..., out_dtype=torch.float32)``). The
  CPU build refuses bf16 operands with an f32 result, so there, and for
  convolutions on both devices, the rounded operands go through the f32
  op: a product of two 8-bit mantissas is exact in f32.

The hand kernels (K1, K4-K6) and their plain versions keep their f32
arithmetic, as the JAX package's Pallas kernels keep theirs, and so do the
vocoder's fixed resampling filters (``ops/resample.py``), which those
plain versions share.
"""

from __future__ import annotations

import contextlib
import threading

import torch

MODES = ("float32", "tensorfloat32", "bfloat16")

_tls = threading.local()


def codec_matmul_mode(value: str) -> str:
    """``value`` (``MIOTTS_CODEC_MATMUL``'s), checked against ``MODES``."""
    if value not in MODES:
        raise ValueError(f"MIOTTS_CODEC_MATMUL must be one of {MODES}, got {value!r}")
    return value


def current() -> str:
    """The mode of this thread's innermost ``codec_matmul`` context."""
    return getattr(_tls, "mode", "float32")


@contextlib.contextmanager
def codec_matmul(mode: str):
    """``mm`` and ``operand`` of this thread use ``mode`` inside."""
    prev = current()
    _tls.mode = codec_matmul_mode(mode)
    try:
        yield
    finally:
        _tls.mode = prev


def operand(x: torch.Tensor) -> torch.Tensor:
    """An f32 matmul or convolution operand rounded to bf16 under
    ``bfloat16``, else ``x`` itself."""
    if current() != "bfloat16":
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] at the current mode, f32 result."""
    if current() != "bfloat16":
        return a @ b
    if a.is_cuda:
        out = torch.mm(a.reshape(-1, a.shape[-1]).to(torch.bfloat16), b.to(torch.bfloat16),
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return operand(a) @ operand(b)
