"""iSTFT head: DFT as a matmul, then a shift-and-add overlap-add
(miotts_tpu/ops/istft.py).

The transform is the reference's own, not a standard inverse real FFT: the
n_freq complex bins are zero-padded to n_fft (no Hermitian mirror),
inverse-transformed with positive-exponent twiddles, and the real part is
scaled by 1/n_freq:

    frame[t] = (1/n_freq) * sum_k ( re_k*cos(2*pi*k*t/n) - im_k*sin(2*pi*k*t/n) )

``torch.fft`` computes a different transform, so the DFT stays a matmul
against the same tables the JAX package uses. Windowing is periodic Hann;
the overlap-add is normalized by the hann^2 envelope and cropped by
(n_fft - hop)/2 per side.
"""

from __future__ import annotations

import numpy as np
import torch


def dft_tables(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables [n_freq, n_fft], f32, already scaled by 1/n_freq."""
    n_freq = n_fft // 2 + 1
    k = np.arange(n_freq, dtype=np.float64)[:, None]
    t = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * t / n_fft
    scale = 1.0 / n_freq
    return (np.cos(ang) * scale).astype(np.float32), (np.sin(ang) * scale).astype(np.float32)


def hann_periodic(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)


def istft_overlap_add(frames_time: torch.Tensor, frame_lengths: torch.Tensor,
                      n_fft: int, hop: int) -> torch.Tensor:
    """frames_time: [B, L, n_fft] real frames -> audio
    [B, (L-1)*hop + n_fft - 2*n_pad].

    Each windowed frame splits into r = ceil(n_fft/hop) hop-chunks and the
    r diagonally shifted streams are summed: no scatter."""
    B, L, nf = frames_time.shape
    if nf != n_fft:
        raise ValueError(f"frames have {nf} samples, expected n_fft={n_fft}")
    r = -(-n_fft // hop)
    n_pad = (n_fft - hop) // 2
    dev = frames_time.device

    hann = torch.from_numpy(hann_periodic(n_fft)).to(dev)
    maskf = (torch.arange(L, dtype=torch.int32, device=dev)[None, :]
             < frame_lengths[:, None]).float()[:, :, None]
    windowed = frames_time.float() * hann[None, None, :] * maskf
    env_frames = (hann * hann)[None, None, :] * maskf

    H = L + r - 1
    frame_pad = r * hop - n_fft

    def ola(x):
        if frame_pad:
            x = torch.nn.functional.pad(x, (0, frame_pad))
        xr = x.reshape(B, L, r, hop)
        acc = torch.zeros((B, H, hop), dtype=torch.float32, device=dev)
        for s in range(r):
            acc[:, s:s + L, :] += xr[:, :, s, :]
        return acc.reshape(B, H * hop)

    audio_ola = ola(windowed)
    env_ola = ola(env_frames)
    audio = torch.where(env_ola > 1e-12, audio_ola / torch.clamp(env_ola, min=1e-12), audio_ola)
    out_size = (L - 1) * hop + n_fft - 2 * n_pad
    return audio[:, n_pad:n_pad + out_size]


def spec_to_audio(spec: torch.Tensor, frame_lengths: torch.Tensor, n_fft: int, hop: int,
                  tables: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """spec: [B, L, n_fft+2] (logmag | phase) -> audio; ``tables`` are the
    (cos, sin) DFT matrices on the spec's device (see ``dft_tables``)."""
    n_freq = n_fft // 2 + 1
    logmag = spec[..., :n_freq].float()
    phase = spec[..., n_freq:].float()
    mag = torch.clamp(torch.exp(logmag), max=1e2)
    re = mag * torch.cos(phase)
    im = mag * torch.sin(phase)
    cos_t, sin_t = tables
    frames_time = torch.matmul(re, cos_t) - torch.matmul(im, sin_t)
    return istft_overlap_add(frames_time, frame_lengths, n_fft, hop)
