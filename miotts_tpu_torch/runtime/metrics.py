"""Audio fidelity metrics (mel-spectrogram L1) for conformance checks
(miotts_tpu/runtime/metrics.py).

BASELINE.md's fidelity target is mel-L1 < 1e-2 vs the GGML reference
output; with no reference binaries/weights available in this environment,
the CPU float32 decode of the same graph serves as the reference stand-in
(the math is oracle-verified; see tests/oracle_miocodec.py).
"""

from __future__ import annotations

import numpy as np


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular (HTK) filterbank."""
    fmax = fmax or sr / 2.0
    n_freq = n_fft // 2 + 1
    mels = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz = _mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * hz / sr).astype(int)
    fb = np.zeros((n_mels, n_freq))
    for m in range(1, n_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, min(c, n_freq)):
            if c > lo:
                fb[m - 1, k] = (k - lo) / (c - lo)
        for k in range(c, min(hi, n_freq)):
            if hi > c:
                fb[m - 1, k] = (hi - k) / (hi - c)
    return fb.astype(np.float32)


def log_mel(audio: np.ndarray, sr: int, n_fft: int = 1024, hop: int = 256,
            n_mels: int = 80) -> np.ndarray:
    """[frames, n_mels] log-mel spectrogram (Hann STFT, power magnitude)."""
    x = np.asarray(audio, np.float64)
    if x.size < n_fft:
        x = np.pad(x, (0, n_fft - x.size))
    n_frames = 1 + (x.size - n_fft) // hop
    win = np.hanning(n_fft)
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft)[::hop][:n_frames]
    spec = np.abs(np.fft.rfft(frames * win, axis=-1)) ** 2
    fb = mel_filterbank(sr, n_fft, n_mels)
    mel = spec @ fb.T
    # 1e-5 floor: keeps near-silent bins from dominating the log-domain
    # distance (a 1e-4 noise floor must read as a small difference)
    return np.log(np.maximum(mel, 1e-5)).astype(np.float32)


def mel_l1(a: np.ndarray, b: np.ndarray, sr: int) -> float:
    """Mean |log-mel difference|, normalized by the reference's dynamic
    range so the value is comparable across content."""
    n = min(a.size, b.size)
    ma = log_mel(a[:n], sr)
    mb = log_mel(b[:n], sr)
    rng = max(1e-6, float(mb.max() - mb.min()))
    return float(np.abs(ma - mb).mean() / rng)
