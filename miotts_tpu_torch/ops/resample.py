"""Length-aware resampling primitives of the mel vocoder in [B, T, C] layout
(miotts_tpu/models/vocoder.py:35-216).

Every op keeps the length-masking invariant: rows at t >= length are
exactly 0 on output, and edge handling (replicate padding) reads the TRUE
per-example edges, so a padded length bucket computes the unpadded math in
its valid rows. They live here rather than in ``models/vocoder.py`` because
the plain versions of kernels K4-K6 (``ops/cuda/``) are built from them
and the vocoder dispatches to those kernels.

The grouped and depthwise convolutions stay ``F.conv1d``, as the JAX
package leaves them to XLA. ``replicate_pad`` is one gather with indices
clamped to [0, length-1]; the JAX package's concat/select form is a TPU
workaround. FIR filters are computed on the host once and cached as
tensors on each device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .cuda.graphs import capturing
from .masking import mask_time


def _hann_symmetric(n: int) -> np.ndarray:
    if n <= 1:
        return np.ones(max(0, n), np.float32)
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))).astype(np.float32)


@functools.lru_cache(maxsize=32)
def julius_lowpass_kernel(cutoff: float, zeros: float = 8.0) -> np.ndarray:
    """Windowed-sinc low-pass (julius convention, miocodec-decoder.cpp:1709-1732)."""
    if cutoff <= 0.0:
        return np.zeros(1, np.float32)
    half = max(1, int(zeros / cutoff / 2.0))
    k = 2 * half + 1
    t = np.arange(k, dtype=np.float64) - half
    x = 2.0 * cutoff * np.pi * t
    s = np.where(np.abs(x) < 1e-12, 1.0, np.sin(x) / np.where(x == 0, 1.0, x))
    filt = 2.0 * cutoff * _hann_symmetric(k).astype(np.float64) * s
    total = filt.sum()
    if abs(total) > 1e-12:
        filt = filt / total
    return filt.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _lowpass_filter(cutoff: float, device: torch.device) -> torch.Tensor:
    """The filter on ``device``, copied from the host once. Refuses to fill
    while a CUDA graph is being captured (a capture cannot hold a host
    copy); the copy does not wait for the device, so the eager warm-up
    before a capture may run under ``torch.cuda.set_sync_debug_mode("error")``."""
    if capturing():
        raise RuntimeError(f"the low-pass filter cache would fill (cutoff {cutoff}) during "
                           f"CUDA graph capture; run the captured body once eagerly first")
    return torch.from_numpy(julius_lowpass_kernel(cutoff)).to(device, non_blocking=True)


def replicate_pad(x: torch.Tensor, lengths: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Replicate-pad along time at the TRUE edges: row i of the result reads
    x[clamp(i - left, 0, length - 1)], so positions below 0 read x[0] and
    positions at or past the length read x[length - 1]."""
    if left == 0 and right == 0:
        return x
    B, T, C = x.shape
    idx = torch.arange(-left, T + right, device=x.device)[None, :]
    last = torch.clamp(lengths.to(torch.int64) - 1, min=0)[:, None]
    idx = torch.minimum(torch.clamp(idx, min=0), last)  # [B, T + left + right]
    return torch.gather(x, 1, idx[:, :, None].expand(B, idx.shape[1], C))


def conv1d_zeropad(x: torch.Tensor, w: torch.Tensor, b, dilation: int, padding: int,
                   groups: int = 1) -> torch.Tensor:
    """conv1d_same semantics (miocodec-decoder.cpp:1751-1781): explicit zero
    padding. x [B, T, Cin], w torch-layout [Cout, Cin/groups, k]."""
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), None, padding=padding,
                 dilation=dilation, groups=groups).transpose(1, 2)
    if b is not None:
        y = y + b
    return y


def depthwise_strided(x: torch.Tensor, filt: torch.Tensor, stride: int) -> torch.Tensor:
    """The same FIR ``filt`` [k] on every channel, valid padding."""
    C, k = x.shape[-1], filt.shape[0]
    w = filt.to(x.dtype).reshape(1, 1, k).expand(C, 1, k).contiguous()
    return F.conv1d(x.transpose(1, 2), w, stride=stride, groups=C).transpose(1, 2)


def zero_stuff(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Insert factor-1 zeros between samples: out[t*factor] = x[t]."""
    B, T, C = x.shape
    y = x.new_zeros(B, T, factor, C)
    y[:, :, 0] = x
    return y.reshape(B, T * factor, C)


def lowpass(x: torch.Tensor, lengths: torch.Tensor, cutoff: float, stride: int = 1):
    """Julius low-pass with replicate edges; returns (y, new_lengths)."""
    cutoff = round(float(cutoff), 9)
    half = julius_lowpass_kernel(cutoff).shape[0] // 2
    xp = replicate_pad(mask_time(x, lengths), lengths, half, half)
    y = depthwise_strided(xp, _lowpass_filter(cutoff, x.device), stride)
    # padded conv out: (T + 2*half - k)/stride + 1 = (T-1)/stride + 1
    new_len = (lengths - 1) // stride + 1
    return mask_time(y, new_len), new_len


def highpass(x: torch.Tensor, lengths: torch.Tensor, cutoff: float) -> torch.Tensor:
    low, _ = lowpass(x, lengths, cutoff, 1)
    return mask_time(x - low, lengths)


def per_time_layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """LayerNorm over channels at each time step (miocodec-decoder.cpp:1803-1841)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) / torch.sqrt(var + eps) * w + b).to(x.dtype)


def upsample_activation(x: torch.Tensor, lengths: torch.Tensor, up_filter: torch.Tensor):
    """2x transposed-filter upsample with replicate pad + crop
    (miocodec-decoder.cpp:1888-1917); returns (y [B, 2T, C], 2 * lengths)."""
    k = up_filter.shape[0]
    ratio = 2
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    xp = replicate_pad(mask_time(x, lengths), lengths, pad, pad)  # [B, T+2p, C]
    B, Tp, C = xp.shape
    # transposed conv: out[t*2 + kk] += x[t] * 2 * f[kk]
    stuffed = zero_stuff(xp * ratio, ratio)  # [B, Tp*2, C]
    w = up_filter.flip(0).to(x.dtype).reshape(1, 1, k).expand(C, 1, k).contiguous()
    y = F.conv1d(stuffed.transpose(1, 2), w, padding=k - 1, groups=C).transpose(1, 2)
    # the conv of the zero-stuffed signal has one extra trailing tap; crop
    # [pad_left, full - pad_right) of the reference's full length
    full = (Tp - 1) * ratio + k
    y = y[:, pad_left:full - pad_right]
    new_len = torch.clamp((lengths + 2 * pad - 1) * ratio + k - pad_left - pad_right, min=0)
    return mask_time(y, new_len), new_len


def adaa_snake_beta(x: torch.Tensor, lengths: torch.Tensor, alpha: torch.Tensor,
                    beta: torch.Tensor) -> torch.Tensor:
    """Antiderivative-antialiased snake-beta (miocodec-decoder.cpp:1933-1951):
    y[t] = (x[t]+x[t-1])/2 + (1 - cos(a*sum)*sinc(a*delta)) / (2*(e^b+1e-9)),
    with x[-1] = 0, a = e^alpha."""
    a, inv = snake_coefficients(alpha, beta)
    xf = x.float()
    prev = F.pad(xf, (0, 0, 1, 0))[:, :-1]
    s = xf + prev
    ad = a * (xf - prev)
    sinc = torch.where(ad.abs() < 1e-12, 1.0, torch.sin(ad) / torch.where(ad == 0, 1.0, ad))
    y = s * 0.5 + inv * (1.0 - torch.cos(a * s) * sinc)
    return mask_time(y.to(x.dtype), lengths)


def snake_coefficients(alpha: torch.Tensor,
                       beta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, inv) of the snake: a = e^alpha, inv = 1 / (2 (e^beta + 1e-9)), f32."""
    return torch.exp(alpha.float()), 1.0 / (2.0 * (torch.exp(beta.float()) + 1e-9))


def downsample_activation(x: torch.Tensor, lengths: torch.Tensor, down_filter: torch.Tensor):
    """Replicate-pad + stride-2 FIR (miocodec-decoder.cpp:1919-1931);
    returns (y, new_lengths)."""
    k = down_filter.shape[0]
    pad_left = k // 2 - (1 if k % 2 == 0 else 0)
    pad_right = k // 2
    xp = replicate_pad(mask_time(x, lengths), lengths, pad_left, pad_right)
    y = depthwise_strided(xp, down_filter, 2)
    new_len = (lengths + pad_left + pad_right - k) // 2 + 1
    return mask_time(y, new_len), new_len
