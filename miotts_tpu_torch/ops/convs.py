"""1-D convolution ops in [B, T, C] layout with torch-convention weights
(miotts_tpu/ops/convs.py). Public functions keep the JAX package's
channels-last layout; the convolutions themselves run channels-first
through ``torch.nn.functional``.

- ``conv1d_same``: pad k//2 on both sides (ggml_conv_1d_ph).
- ``conv_transpose1d``: stride s, pad 0, out_len = (T-1)*s + k.
- ``linear_interpolate``: half-pixel bilinear resize along time, with the
  scale taken from each example's TRUE source/target lengths (or pinned by
  an anchor), so a padded length bucket reproduces the unpadded ratio.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d_same(x: torch.Tensor, w: torch.Tensor, b=None, dilation: int = 1) -> torch.Tensor:
    """x [B, T, Cin], w [Cout, Cin, k]; pad k//2 both sides."""
    k = w.shape[-1]
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), None, padding=k // 2, dilation=dilation)
    y = y.transpose(1, 2)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1) -> torch.Tensor:
    """x [B, T, Cin], w [Cin, Cout, k], padding 0."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype), None, stride=stride)
    y = y.transpose(1, 2)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def linear_interpolate(
    x: torch.Tensor,
    src_lengths: torch.Tensor,
    dst_lengths: torch.Tensor,
    dst_size: int,
    scale_override: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Per-example bilinear resize along time with half-pixel centers.

    x: [B, T_src, C]; output [B, dst_size, C], valid for t < dst_lengths[b]
    (the rest is clamped garbage that callers mask). dx comes from the
    unclamped floor, then indices clamp to [0, src_len - 1], as in GGML.
    ``scale_override = (src_anchor, dst_anchor)`` pins the ratio."""
    B, T_src, C = x.shape
    dst_idx = torch.arange(dst_size, dtype=torch.float32, device=x.device)[None, :]
    if scale_override is not None:
        sf = torch.full((B,), scale_override[1] / scale_override[0],
                        dtype=torch.float32, device=x.device)
    else:
        sf = dst_lengths.float() / torch.clamp(src_lengths.float(), min=1.0)
    pos = (dst_idx + 0.5) / sf[:, None] - 0.5
    x0f = torch.floor(pos)
    dx = pos - x0f
    max_idx = torch.clamp(src_lengths - 1, min=0)[:, None].to(torch.int64)
    base = x0f.to(torch.int64)
    x0 = torch.minimum(torch.clamp(base, min=0), max_idx)
    x1 = torch.minimum(torch.clamp(base + 1, min=0), max_idx)
    g0 = torch.gather(x, 1, x0[:, :, None].expand(B, dst_size, C))
    g1 = torch.gather(x, 1, x1[:, :, None].expand(B, dst_size, C))
    return g0 + (g1 - g0) * dx[:, :, None].to(x.dtype)
