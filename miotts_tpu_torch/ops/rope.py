"""Rotary position embedding (miotts_tpu/ops/rope.py).

NORM (GGML mode 0, the codec's): adjacent pairs (x[2i], x[2i+1]) rotate by
``pos * theta^(-2i/D)``. NEOX (the Qwen-family LLM's): pairs
(x[i], x[i + D/2]).
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta_base: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim//2] for positions [...]."""
    half = head_dim // 2
    exponents = torch.arange(half, dtype=torch.float32, device=positions.device) * (-2.0 / head_dim)
    inv_freq = torch.pow(theta_base, exponents)  # theta^(-2i/d), f32
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta_base: float = 10000.0, neox: bool = False) -> torch.Tensor:
    """x: [B, T, H, D] (D even), positions: [T] or [B, T]."""
    B, T, H, D = x.shape
    cos, sin = rope_angles(positions, D, theta_base)
    if cos.ndim == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    xf = x.float()
    if neox:
        x0, x1 = xf[..., : D // 2], xf[..., D // 2:]
        y = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    else:
        xp = xf.reshape(B, T, H, D // 2, 2)
        y0 = xp[..., 0] * cos - xp[..., 1] * sin
        y1 = xp[..., 0] * sin + xp[..., 1] * cos
        y = torch.stack([y0, y1], dim=-1).reshape(B, T, H, D)
    return y.to(x.dtype)
