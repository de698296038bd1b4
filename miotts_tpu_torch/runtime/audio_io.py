"""16-bit PCM WAV output (the WAV pieces of miotts_tpu/runtime/audio_io.py).

Only what the port writes: the canonical 44-byte mono header, the
streaming header whose sizes are patched when the stream ends, the f32 ->
int16 encoding (clamp to [-1, 1], round half to even at 32767 scale), a
whole WAV in memory (the server's response body; the JAX package's native
C++ encoder gives the same bytes) and a file writer. Reading and decoding reference audio (native, FLAC, MP3) is
voice-cloning input, not yet ported.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def wav16_header(n_samples: int, sample_rate: int, num_channels: int = 1) -> bytes:
    bits = 16
    byte_rate = sample_rate * num_channels * (bits // 8)
    block_align = num_channels * (bits // 8)
    data_size = n_samples * (bits // 8)
    return struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + data_size, b"WAVE",
        b"fmt ", 16, 1, num_channels, sample_rate, byte_rate, block_align, bits,
        b"data", data_size,
    )


def wav16_streaming_header(sample_rate: int, num_channels: int = 1) -> bytes:
    """WAV header for incremental delivery of a stream whose final length is
    unknown when the response starts: RIFF/data sizes carry the 0xFFFFFFFF
    streaming convention."""
    bits = 16
    byte_rate = sample_rate * num_channels * (bits // 8)
    block_align = num_channels * (bits // 8)
    return struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 0xFFFFFFFF, b"WAVE",
        b"fmt ", 16, 1, num_channels, sample_rate, byte_rate, block_align, bits,
        b"data", 0xFFFFFFFF,
    )


def encode_pcm16(audio: np.ndarray) -> bytes:
    """f32 [-1,1] -> little-endian 16-bit PCM bytes, no header. int16 input
    passes through untouched."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        return audio.astype("<i2", copy=False).tobytes()
    x = np.clip(audio.astype(np.float32), -1.0, 1.0)
    return np.rint(x * 32767.0).astype("<i2").tobytes()


def encode_wav16(audio: np.ndarray, sample_rate: int) -> bytes:
    """A whole mono 16-bit WAV: header + ``encode_pcm16`` of ``audio``
    (device-quantized int16 passes through)."""
    pcm = encode_pcm16(audio)
    return wav16_header(len(pcm) // 2, sample_rate) + pcm


def save_wav16(path: str | Path, audio: np.ndarray, sample_rate: int) -> None:
    pcm = encode_pcm16(audio)
    Path(path).write_bytes(wav16_header(len(pcm) // 2, sample_rate) + pcm)
