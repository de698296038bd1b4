"""Normalization ops matching GGML semantics (miotts_tpu/ops/norms.py).

- ``layer_norm``: normalize over the last axis, eps inside the sqrt.
- ``masked_group_norm``: statistics per (batch, group) over the VALID time
  steps x channels-in-group, so a padded batch reproduces the unpadded math.
- ``adaln_modulate``: AdaLN-Zero apply, ``x_norm * (1 + scale) + shift``.
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, weight=None, bias=None, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = centered * torch.reciprocal(torch.sqrt(var + eps))
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def adaln_modulate(x_norm: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x_norm [B, T, C], shift/scale [B, C]."""
    return x_norm * (1.0 + scale[:, None, :]) + shift[:, None, :]


def group_view(x: torch.Tensor, lengths: torch.Tensor, num_groups: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x as f32 [B, T, G, C/G], the valid-row mask [B, T, 1, 1] of ``lengths``)."""
    B, T, C = x.shape
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    xf = x.float().reshape(B, T, num_groups, C // num_groups)
    mask = (torch.arange(T, dtype=torch.int32, device=x.device)[None, :]
            < lengths[:, None]).float()
    return xf, mask[:, :, None, None]


def group_count(lengths: torch.Tensor, cg: int) -> torch.Tensor:
    """The valid elements of each (batch, group): length x channels-in-group, at least 1."""
    return torch.clamp(lengths.float() * cg, min=1.0)[:, None, None, None]


def group_normalize(x: torch.Tensor, xf: torch.Tensor, m: torch.Tensor, mean: torch.Tensor,
                    var: torch.Tensor, eps: float) -> torch.Tensor:
    """(xf - mean) / sqrt(var + eps), padded rows 0, in x's shape and dtype."""
    y = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    y = y * m
    return y.reshape(x.shape).to(x.dtype)


def masked_group_norm(x: torch.Tensor, lengths: torch.Tensor, num_groups: int,
                      eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over [B, T, C] with stats per (batch, group) over valid
    (time x channels-in-group); no affine. Padded rows come out zero."""
    xf, m = group_view(x, lengths, num_groups)
    count = group_count(lengths, xf.shape[-1])
    mean = (xf * m).sum(dim=(1, 3), keepdim=True) / count
    var = (torch.square(xf - mean) * m).sum(dim=(1, 3), keepdim=True) / count
    return group_normalize(x, xf, m, mean, var, eps)
