"""Length-mask helpers for padded, length-bucketed batches
(miotts_tpu/ops/masking.py)."""

from __future__ import annotations

import torch


def time_mask(max_len: int, lengths: torch.Tensor) -> torch.Tensor:
    """[B, max_len] boolean mask, True for valid positions t < lengths[b]."""
    t = torch.arange(max_len, dtype=torch.int32, device=lengths.device)
    return t[None, :] < lengths[:, None]


def mask_time(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero out padded time steps of [B, T, ...]: everything at
    t >= lengths[b] is exactly zero, so same-padded convs at the true
    sequence boundary see the same zeros as an unpadded run."""
    mask = time_mask(x.shape[1], lengths)
    return x * mask.reshape(mask.shape + (1,) * (x.ndim - 2)).to(x.dtype)
