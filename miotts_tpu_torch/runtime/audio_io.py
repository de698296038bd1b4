"""WAV output and reference-audio input (miotts_tpu/runtime/audio_io.py).

Output: the canonical 44-byte mono header, the streaming header whose
sizes are patched when the stream ends, the f32 -> int16 encoding (clamp
to [-1, 1], round half to even at 32767 scale), a whole WAV in memory
(the server's response body: the native C++ encoder of ``native.py``
first for f32 audio, numpy when the library is unavailable, the same
bytes either way) and a file writer through it.

Input (voice cloning): ``load_audio`` decodes a reference file to f32
mono, then resamples it linearly and cuts it to a length. WAV (PCM 8/16/24/
32, float 32/64, mixed to mono by channel average) is parsed here; FLAC
and mp3 go to the native C++ decoders of ``native.py``
(``flac_decode_native``, ``mp3_decode_native``; native mp3 is on unless
MIOTTS_NATIVE_MP3=0, where JAX's is opt-in) and to the numpy decoders of
``flac.py`` and ``mp3.py`` when those return None, with the same samples;
any other container, or an mp3 neither decoder takes, goes to torchaudio
where it is installed, then to an ffmpeg subprocess where ffmpeg is on
PATH. Left out of the JAX package's chain on purpose: pygame's SDL_mixer.
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
    (device-quantized int16 passes through), native first for any other
    dtype."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        from .native import encode_wav16_native

        native = encode_wav16_native(audio.astype(np.float32), sample_rate)
        if native is not None:
            return native
    pcm = encode_pcm16(audio)
    return wav16_header(len(pcm) // 2, sample_rate) + pcm


def save_wav16(path: str | Path, audio: np.ndarray, sample_rate: int) -> None:
    Path(path).write_bytes(encode_wav16(audio, sample_rate))


def _parse_wav(data: bytes) -> tuple[np.ndarray, int]:
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        csize = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + csize]
        if cid == b"fmt ":
            (audio_format, channels, rate, _br, _ba, bits) = struct.unpack_from("<HHIIHH", body, 0)
            if audio_format == 0xFFFE and csize >= 40:  # WAVE_FORMAT_EXTENSIBLE
                audio_format = struct.unpack_from("<H", body, 24)[0]
            fmt = (audio_format, channels, rate, bits)
        elif cid == b"data":
            samples = body
        pos += 8 + csize + (csize & 1)
    if fmt is None or samples is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, rate, bits = fmt
    if audio_format == 1:  # PCM
        if bits == 8:
            x = (np.frombuffer(samples, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(samples, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(samples, np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
            vals = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(samples, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(samples, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format tag {audio_format}")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), rate


def resample_linear(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Linear resampler of the reference's WavLM input path
    (wavlm-extractor.cpp:218-240): src_pos = i * src/dst, a clamped gather
    of the two neighbours."""
    if src_rate == dst_rate or x.size == 0:
        return x
    n_dst = int(round(x.size * (dst_rate / src_rate)))
    if n_dst <= 0:
        return np.zeros(0, np.float32)
    pos = np.arange(n_dst, dtype=np.float64) * (src_rate / dst_rate)
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    i0 = np.clip(i0, 0, x.size - 1)
    i1 = np.clip(i0 + 1, 0, x.size - 1)
    return (x[i0] * (1.0 - frac) + x[i1] * frac).astype(np.float32)


def _mp3_info(data: bytes) -> tuple[int, int] | None:
    """(sample_rate, channels) from the first MPEG audio frame header, or
    None if no sync is found in the first 64 KiB. Skips a leading ID3v2 tag
    (syncsafe size)."""
    pos = 0
    if data[:3] == b"ID3" and len(data) >= 10:
        size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) \
            | ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
        pos = 10 + size
    end = min(len(data) - 3, pos + 65536)
    rates = {3: (44100, 48000, 32000),   # MPEG1
             2: (22050, 24000, 16000),   # MPEG2
             0: (11025, 12000, 8000)}    # MPEG2.5
    while pos < end:
        if data[pos] == 0xFF and (data[pos + 1] & 0xE0) == 0xE0:
            version = (data[pos + 1] >> 3) & 3
            layer = (data[pos + 1] >> 1) & 3
            sr_idx = (data[pos + 2] >> 2) & 3
            if version != 1 and layer != 0 and sr_idx != 3:
                rate = rates[version][sr_idx]
                channels = 1 if ((data[pos + 3] >> 6) & 3) == 3 else 2
                return rate, channels
        pos += 1
    return None


def _decode_via_torchaudio(path: str) -> tuple[np.ndarray, int] | None:
    """torchaudio's loader where the package is installed, mixed to mono."""
    try:
        import torchaudio  # type: ignore
    except ImportError:
        return None
    try:
        wav, rate = torchaudio.load(str(path))
    except Exception:
        return None
    return wav.mean(dim=0).numpy().astype(np.float32), int(rate)


def _decode_via_ffmpeg(path: str, rate_hint: int | None) -> tuple[np.ndarray, int] | None:
    """An ffmpeg subprocess decoding to raw f32 mono on stdout (None when
    ffmpeg is not on PATH or fails)."""
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:
        return None
    rate = int(rate_hint or 44100)
    try:
        p = subprocess.run(
            ["ffmpeg", "-v", "error", "-i", str(path), "-f", "f32le",
             "-acodec", "pcm_f32le", "-ac", "1", "-ar", str(rate), "-"],
            capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    if p.returncode != 0 or not p.stdout:
        return None
    return np.frombuffer(p.stdout, np.float32).copy(), rate


def load_audio(path: str | Path, target_rate: int | None = None,
               max_seconds: float | None = None) -> tuple[np.ndarray, int]:
    """Decode an audio file to f32 mono, optionally resample and truncate
    (the reference's miniaudio surface, wavlm-extractor.cpp:153-203). WAV,
    FLAC and mp3 (native C++ first, numpy when it returns None) decode
    here; other containers go to torchaudio, then an ffmpeg subprocess."""
    data = Path(path).read_bytes()
    if data[:4] == b"RIFF":
        x, rate = _parse_wav(data)
    elif data[:4] == b"fLaC":
        from .native import flac_decode_native

        res = flac_decode_native(data)
        if res is None:
            from .flac import decode_flac

            res = decode_flac(data)
        x, rate = res
    else:
        mp3 = _mp3_info(data)
        rate_hint = mp3[0] if mp3 else None
        res = None
        if mp3 is not None:
            from .native import mp3_decode_native

            res = mp3_decode_native(data)
            if res is None:
                from .mp3 import decode_mp3

                try:
                    res = decode_mp3(data)
                except Exception:  # a corrupt stream: try the containers below
                    res = None
        if res is None:
            res = _decode_via_torchaudio(str(path))
        if res is None:
            res = _decode_via_ffmpeg(str(path), rate_hint)
        if res is None:
            raise ValueError(
                f"cannot decode audio file {path}: WAV, FLAC, and mp3 "
                "decode natively; other containers (ogg/m4a/...) need "
                "torchaudio or ffmpeg installed")
        x, rate = res
    if target_rate is not None and rate != target_rate:
        x = resample_linear(x, rate, target_rate)
        rate = target_rate
    if max_seconds is not None and max_seconds > 0:
        x = x[: int(max_seconds * rate)]
    return x, rate
