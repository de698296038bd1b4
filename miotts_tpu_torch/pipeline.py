"""MioTTS synthesis context: codec loading and length-bucketed synthesis
(miotts_tpu/pipeline.py:31, 90-292).

Requests are padded into the same ladder of length buckets as the JAX
package, so both packages decode the same padded shapes.
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


class MioTTSPipeline:
    """Codec weights on one device, shared by every synthesis call."""

    def __init__(self, codec_path: str | Path, device: torch.device,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS):
        self.codec_path = str(codec_path)
        self.device = device
        self.config, self.weights = load_miocodec(self.codec_path, device)
        self.buckets = buckets

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

    def synthesize(self, codes, embedding: np.ndarray | None = None) -> SynthesisResult:
        """codes -> peak-normalized waveform (mio_tts_synthesize,
        mio-tts-lib.cpp:1182-1323)."""
        codes, embedding = self.validate_request(codes, embedding)
        n = int(codes.size)
        tokens = np.zeros((1, pick_bucket(n, self.buckets)), np.int64)
        tokens[0, :n] = codes
        dev = self.device
        t0 = time.perf_counter()
        audio, n_samples = codec_synthesize(
            self.config, self.weights, torch.from_numpy(tokens).to(dev),
            torch.tensor([n], dtype=torch.int32, device=dev),
            None if embedding is None else torch.from_numpy(embedding)[None].to(dev))
        n_valid = int(n_samples[0])
        audio = audio[0, :n_valid].cpu().numpy()  # the copy waits for the device
        decode_ms = (time.perf_counter() - t0) * 1e3
        return SynthesisResult(audio=audio, sample_rate=self.config.sample_rate,
                               decode_ms=decode_ms, n_codes=n,
                               n_frames=n_valid // self.config.hop_length)
