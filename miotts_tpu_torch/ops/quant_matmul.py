"""Quantized matmul weights for the LLM (miotts_tpu/ops/pallas/quant_matmul.py).

Three leaf kinds, each a transposed [K, N] weight kept quantized on the
device, with the JAX package's layouts and host quantizers (numpy, bit for
bit the same):

- Q8_0 blocks ``{"q": int8 [K, N], "s": f32 [K/32, N]}``: the shipped
  MioTTS-0.1B storage, one f16-rounded scale per 32 rows of a column. The
  product runs on kernel K3 (``ops/cuda/q8_matmul.py``).
- W8A8 ``{"q8": int8 [K, N], "s8": f32 [N]}``: one scale per column and
  dynamically quantized int8 activations, one scale per row.
- W4A8 ``{"q4i8" (or "q4"): int8 storage of [-7, 7], "s4": f32 [N]}``.

The W8A8 and W4A8 products are exact integer dots, then scaled in f32: the
JAX package computes them in plain XLA, outside any Pallas kernel, and so
does the port in plain PyTorch. The int32 dot is an int32 matmul on the CPU
and ``torch._int_mm`` (cuBLASLt int8 x int8 -> int32) on CUDA, with the rows
padded to at least 17 because it refuses 16 or fewer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .cuda.q8_matmul import QBLOCK, q8_matmul


def quantize_q8_cols(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize a [K, N] float weight to Q8_0-style blocks along K.
    Returns (wq int8 [K, N], scales f32 [K//32, N])."""
    K, N = w.shape
    assert K % QBLOCK == 0
    blocks = w.reshape(K // QBLOCK, QBLOCK, N).astype(np.float32)
    amax = np.abs(blocks).max(axis=1)  # [K/32, N]
    d = (amax / 127.0).astype(np.float16).astype(np.float32)  # f16 scale like Q8_0
    q = np.round(blocks / np.where(d == 0, 1, d)[:, None, :]).astype(np.int8)
    return q.reshape(K, N), d


def quantize_int8_percol(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize a [K, N] float weight per output column.
    Returns (q8 int8 [K, N], s8 f32 [N]) with w ~= q8 * s8[None, :]."""
    amax = np.abs(w).max(axis=0)
    s = (amax / 127.0).astype(np.float32)
    q = np.round(w / np.where(s == 0, 1, s)[None, :])
    return np.clip(q, -127, 127).astype(np.int8), s


def quantize_int4_percol(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize a [K, N] float weight per output column to 4-bit symmetric
    ([-7, 7]). Returns (q4 stored as int8 [K, N], s4 f32 [N])."""
    amax = np.abs(w).max(axis=0)
    s = (amax / 7.0).astype(np.float32)
    q = np.round(w / np.where(s == 0, 1, s)[None, :])
    return np.clip(q, -7, 7).astype(np.int8), s


def dequant_dense(w: dict) -> torch.Tensor:
    """Expand a Q8_0 leaf to a dense f32 [..., K, N] matrix."""
    return w["q"].float() * w["s"].repeat_interleave(QBLOCK, dim=-2)


def _int_dot(x8: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """Exact int8 [T, K] x int8 [K, N] -> int32 [T, N]."""
    if x8.device.type == "cpu":
        return x8.int() @ q8.int()
    T = x8.shape[0]
    if T < 17:
        x8 = F.pad(x8, (0, 0, 0, 17 - T))
    return torch._int_mm(x8, q8)[:T]


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """The largest |x| of each row of x [..., K], as f32 [rows, 1]."""
    return x.reshape(-1, x.shape[-1]).float().abs().amax(dim=-1, keepdim=True)


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """The int8 activation scale of rows whose largest |x| is ``amax``."""
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def int8_dot(x: torch.Tensor, q: torch.Tensor, sx: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact integer part of a W8A8/W4A8 product: x [..., K] quantized
    a row to int8 (scales ``sx`` [rows, 1], or each row's own) times q [K,
    N] (int8 storage) -> (int32 [rows, N], sx). A tensor-parallel rank
    passes the whole rows' scales for its K slice, so the ranks' int32
    parts sum to the single device's dot exactly."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    if sx is None:
        sx = act_scale(x2.abs().amax(dim=-1, keepdim=True))
    x8 = torch.round(x2 / sx).to(torch.int8)
    return _int_dot(x8, q.to(torch.int8)), sx


def int_scale(dot: torch.Tensor, sx: torch.Tensor, s: torch.Tensor, lead) -> torch.Tensor:
    """An int32 dot [rows, N] scaled by the rows' and the columns' scales:
    f32 [*lead, N]."""
    return (dot.float() * sx * s[None, :]).reshape(*lead, -1)


def int8_matmul(x: torch.Tensor, q8: torch.Tensor, s8: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ (q8 [K, N] * s8 [N]) with dynamic per-row activation
    quantization; returns f32 [..., N]."""
    return int_scale(*int8_dot(x, q8), s8, x.shape[:-1])


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ (q4 [K, N] * s4 [N]): the int8 path on [-7, 7] weights."""
    return int8_matmul(x, q4, s4)


def maybe_quant_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w -> [..., N] in x's dtype. ``w`` is a dense [K, N]
    tensor or a quantized leaf dict (module docstring); the Q8_0 leaf runs
    on K3, whose f32 result is rounded to x's dtype as the JAX package's
    ``maybe_quant_matmul`` does."""
    if not isinstance(w, dict):
        return x @ w
    if "q4" in w or "q4i8" in w:
        return int4_matmul(x, w["q4"] if "q4" in w else w["q4i8"], w["s4"]).to(x.dtype)
    if "q8" in w:
        return int8_matmul(x, w["q8"], w["s8"]).to(x.dtype)
    lead = x.shape[:-1]
    y = q8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w["q"], w["s"])
    return y.reshape(*lead, -1).to(x.dtype)
