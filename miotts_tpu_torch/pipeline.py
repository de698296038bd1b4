"""MioTTS synthesis context: codec loading and length-bucketed synthesis
(miotts_tpu/pipeline.py:31-63, 90-292).

Requests are padded into the same ladder of length buckets as the JAX
package, so both packages decode the same padded shapes. A decode's result
reaches the host in one copy: the audio row and its valid-sample count
packed together on the device, or, for the streaming synthesizer, only a
window of the audio and the count (``synthesize(window=...)``).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from . import MIO_CODE_MAX, MIO_CODE_MIN
from .models.miocodec import codec_synthesize, load_miocodec

DEFAULT_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048)


def _window_slice(audio: torch.Tensor, starts: torch.Tensor, window: int) -> torch.Tensor:
    """[B, window]: audio[b, starts[b]:starts[b] + window] per lane, zeros
    beyond each row (miotts_tpu/pipeline.py _window_slice)."""
    T = audio.shape[1]
    idx = starts[:, None].long() + torch.arange(window, device=audio.device)[None, :]
    win = torch.gather(audio, 1, idx.clamp(0, T - 1))
    return torch.where(idx < T, win, torch.zeros((), dtype=win.dtype, device=win.device))


def _fetch(audio: torch.Tensor, n_samples: torch.Tensor, pcm16: bool) -> tuple[np.ndarray, int]:
    """One device -> host copy of a row of audio [L] and its valid-sample
    count [1]: f32 with the count (exact in f32 below 2^24) appended, or,
    with ``pcm16``, quantized on the device as ``audio_io.encode_pcm16``
    does (clip to [-1, 1], x 32767, round half to even) into int16 with the
    int32 count bitcast into two more; the host scales it back to f32."""
    if not pcm16:
        packed = torch.cat([audio.float(), n_samples.float()]).cpu().numpy()
        return packed[:-1], int(packed[-1])
    pcm = torch.round(audio.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
    packed = torch.cat([pcm, n_samples.to(torch.int32).view(torch.int16)]).cpu().numpy()
    return packed[:-2].astype(np.float32) / np.float32(32767.0), int(packed[-2:].view(np.int32)[0])


def pick_bucket(n: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 511) // 512) * 512


@dataclasses.dataclass
class SynthesisResult:
    audio: np.ndarray  # f32 mono, valid samples only
    sample_rate: int
    decode_ms: float
    n_codes: int
    n_frames: int
    # window fetch (streaming): audio is the slice [window_start,
    # window_start + len(audio)) of the decode, and n_total is the decode's
    # count of valid samples
    window_start: int = 0
    n_total: int | None = None


class MioTTSPipeline:
    """Codec weights on one device, shared by every synthesis call."""

    def __init__(self, codec_path: str | Path, device: torch.device,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS):
        self.codec_path = str(codec_path)
        self.device = device
        self.config, self.weights = load_miocodec(self.codec_path, device)
        self.buckets = buckets
        # decodes run and their host time, for callers that count them
        self.n_decodes = 0
        self.decode_ms_total = 0.0

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def samples_per_token(self) -> int:
        return self.config.samples_per_token

    def validate_request(self, codes, embedding) -> tuple[np.ndarray, np.ndarray | None]:
        """mio_tts_synthesize preconditions (mio-tts-lib.cpp:1198-1234).
        Returns normalized (codes, embedding)."""
        codes = np.asarray(codes, dtype=np.int32).reshape(-1)
        if codes.size == 0:
            raise ValueError("codes are empty")
        if codes.min() < MIO_CODE_MIN or codes.max() > MIO_CODE_MAX:
            if codes.max() >= self.config.vocab_size or codes.min() < 0:
                raise ValueError("code id out of range")
        if self.config.dynamic_global and embedding is None:
            raise ValueError("dynamic-global MioCodec requires embedding")
        if not self.config.dynamic_global and embedding is not None:
            raise ValueError("static MioCodec does not accept external embedding")
        if embedding is not None:
            embedding = np.asarray(embedding, dtype=np.float32).reshape(-1)
            if embedding.size != self.config.decoder_adanorm_dim:
                raise ValueError("embedding dimension mismatch")
        return codes, embedding

    def synthesize(self, codes, embedding: np.ndarray | None = None,
                   interp_anchor: int | None = None, peak_normalize: bool = True,
                   window: tuple[int, int] | None = None, pcm16: bool = False
                   ) -> SynthesisResult:
        """codes -> waveform (mio_tts_synthesize, mio-tts-lib.cpp:1182-1323),
        peak-normalized unless ``peak_normalize`` is False; ``interp_anchor``
        pins the resample ratio (streaming prefix re-decodes).

        ``window=(start, length)`` brings back only audio[start:start +
        length] and the decode's total count (``n_total``): a streaming
        feed's emission is a small slice of its prefix decode.

        ``pcm16`` brings the audio back as 16-bit PCM (half the bytes); the
        result's audio is those values scaled back to f32."""
        codes, embedding = self.validate_request(codes, embedding)
        n = int(codes.size)
        tokens = np.zeros((1, pick_bucket(n, self.buckets)), np.int64)
        tokens[0, :n] = codes
        dev = self.device
        t0 = time.perf_counter()
        audio, n_samples = codec_synthesize(
            self.config, self.weights, torch.from_numpy(tokens).to(dev),
            torch.tensor([n], dtype=torch.int32, device=dev),
            None if embedding is None else torch.from_numpy(embedding)[None].to(dev),
            interp_anchor_tokens=interp_anchor, peak_normalize=peak_normalize)
        # one copy (it waits for the device): the audio and its count
        if window is not None:
            start, length = int(window[0]), int(window[1])
            win = _window_slice(audio, torch.tensor([start], device=dev), length)[0]
            audio_np, n_valid = _fetch(win, n_samples[:1], pcm16)
            audio_np = audio_np[:max(0, min(length, n_valid - start))]
        else:
            audio_np, n_valid = _fetch(audio[0], n_samples[:1], pcm16)
            audio_np = audio_np[:n_valid]
        decode_ms = (time.perf_counter() - t0) * 1e3
        self.n_decodes += 1
        self.decode_ms_total += decode_ms
        return SynthesisResult(audio=audio_np, sample_rate=self.config.sample_rate,
                               decode_ms=decode_ms, n_codes=n,
                               n_frames=n_valid // self.config.hop_length,
                               window_start=0 if window is None else start,
                               n_total=None if window is None else n_valid)
