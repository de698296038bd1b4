"""Banded (local-window) multi-head attention (miotts_tpu/ops/attention.py).

The codec transformers attend within |k - q| <= window//2 (window 65). A
key is admitted iff it lies in the band and below the sequence's length; a
query always attends to itself, so padded query rows stay finite. Scores
and softmax run in f32.

Dispatch is by the tensor's device: a CPU tensor takes a plain version
(dense up to T = 256 or T <= window, windowed-blocked above, as the JAX
package's non-TPU rule); a CUDA tensor always launches the hand-written
kernel (``ops/cuda/banded_attention.py``), or raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_DENSE_MAX_T = 256


def band_length_mask(seq: int, window: int, lengths: torch.Tensor) -> torch.Tensor:
    """[B, seq, seq] boolean: allow iff |k - q| <= window//2 and k < length,
    with the diagonal always allowed."""
    half = max(0, window // 2)
    q = torch.arange(seq, dtype=torch.int32, device=lengths.device)
    band = (q[:, None] - q[None, :]).abs() <= half
    valid_k = q[None, :] < lengths[:, None]
    allow = band[None, :, :] & valid_k[:, None, :]
    diag = torch.eye(seq, dtype=torch.bool, device=lengths.device)[None]
    return allow | diag


def _masked_softmax(scores: torch.Tensor, allow: torch.Tensor) -> torch.Tensor:
    scores = scores.masked_fill(~allow, float("-inf"))
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return probs / probs.sum(dim=-1, keepdim=True)


def banded_attention_dense(q, k, v, lengths, window: int) -> torch.Tensor:
    """Dense path: materializes [T, T] scores. q/k/v [B, T, H, D]."""
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = _masked_softmax(scores, band_length_mask(T, window, lengths)[:, None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def banded_attention_blocked(q, k, v, lengths, window: int, block_q: int = 128) -> torch.Tensor:
    """Windowed-gather path, O(T * (block + 2*half)) memory: each query
    block attends to the key slice [i*block - half, i*block + block + half).
    Equals the dense path."""
    B, T, H, D = q.shape
    half = max(0, window // 2)
    Tp = -(-T // block_q) * block_q
    if Tp != T:
        pad = (0, 0, 0, 0, 0, Tp - T)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    nb = Tp // block_q
    W = block_q + 2 * half
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    hpad = (0, 0, 0, 0, half, half)
    kp, vp = F.pad(k, hpad), F.pad(v, hpad)
    idx = (torch.arange(nb, device=dev)[:, None] * block_q
           + torch.arange(W, device=dev)[None, :])  # [nb, W]
    kw, vw = kp[:, idx], vp[:, idx]  # [B, nb, W, H, D]
    qb = q.reshape(B, nb, block_q, H, D)

    scores = torch.einsum("bnqhd,bnkhd->bnhqk", qb.float(), kw.float()) * scale
    q_pos = (torch.arange(nb, device=dev)[:, None] * block_q
             + torch.arange(block_q, device=dev)[None, :])  # [nb, BQ]
    k_pos = idx - half
    band = (k_pos[:, None, :] - q_pos[:, :, None]).abs() <= half  # [nb, BQ, W]
    valid = ((k_pos[None, :, None, :] < lengths[:, None, None, None])
             & (k_pos[None, :, None, :] >= 0))  # [B, nb, 1, W]
    diag = k_pos[:, None, :] == q_pos[:, :, None]
    allow = (band[None] & valid) | diag[None]  # [B, nb, BQ, W]
    probs = _masked_softmax(scores, allow[:, :, None])
    out = torch.einsum("bnhqk,bnkhd->bnqhd", probs, vw.float())
    return out.reshape(B, Tp, H, D)[:, :T].to(q.dtype)


def banded_attention_plain(q, k, v, lengths, window: int) -> torch.Tensor:
    """The plain version the CPU takes: dense at short T, blocked above."""
    T = q.shape[1]
    if T <= _DENSE_MAX_T or T <= window:
        return banded_attention_dense(q, k, v, lengths, window)
    return banded_attention_blocked(q, k, v, lengths, window)


def banded_attention(q, k, v, lengths, window: int) -> torch.Tensor:
    """q/k/v: [B, T, H, D] (post-RoPE), lengths [B]. Returns [B, T, H, D]."""
    if q.device.type == "cpu":
        return banded_attention_plain(q, k, v, lengths, window)
    from .cuda.banded_attention import banded_attention_folded

    B, T, H, D = q.shape

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()

    lens = lengths.to(torch.int32).repeat_interleave(H)
    out = banded_attention_folded(fold(q), fold(k), fold(v), lens, window)
    return out.reshape(B, H, T, D).permute(0, 2, 1, 3)
