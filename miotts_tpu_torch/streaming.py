"""Streaming synthesis: incremental codes -> audio with bounded lookahead
(miotts_tpu/streaming.py).

The codec transformers use window-65 local attention, so a frame's value
settles once enough later tokens are present. The synthesizer re-decodes
growing prefixes (with the resample ratio pinned by ``INTERP_ANCHOR``) and
emits the samples more than ``lookahead_tokens`` behind the prefix end; a
short raised-cosine crossfade at each emission boundary masks what is left
of the boundary drift. Each re-decode brings back only a window of its
audio (``MioTTSPipeline.synthesize(window=...)``).

``stream_text_to_audio`` interleaves chunked LLM generation
(``LLMEngine.generate_audio_tokens_streaming``; on CUDA each chunk is one
replay of a captured decode graph) with these re-decodes.
"""

from __future__ import annotations

import inspect

import numpy as np

from .models.llm import CHUNK
from .pipeline import MioTTSPipeline


class StreamingSynthesizer:
    """Feed codes incrementally; receive stable PCM increments.

    Usage:
        ss = StreamingSynthesizer(pipeline, embedding)
        for chunk in code_chunks:
            pcm = ss.feed(chunk)      # f32 samples newly finalized
        pcm = ss.finalize()           # remaining samples
    """

    # fixed fetch-window length: must cover one feed's emission
    # (CHUNK * spt) plus the crossfade margin the NEXT boundary reads
    # back
    WINDOW_SAMPLES = 32768

    INTERP_ANCHOR = 1024  # fixed resample ratio across prefix re-decodes

    def __init__(self, pipeline: MioTTSPipeline, embedding: np.ndarray | None,
                 lookahead_tokens: int = 8, crossfade_samples: int = 128,
                 min_decode_tokens: int = 4, synth_fn=None, window_samples: int | None = None,
                 transfer_pcm16: bool = False):
        self.pipeline = pipeline
        self.embedding = embedding
        self.lookahead = max(0, lookahead_tokens)
        self.crossfade = max(0, crossfade_samples)
        self.min_decode = max(1, min_decode_tokens)
        self.window = window_samples or self.WINDOW_SAMPLES
        # int16 window transfers (``synthesize(pcm16=True)``): half the
        # bytes, the same quantization a WAV16 output applies anyway
        self.transfer_pcm16 = bool(transfer_pcm16)
        self.codes: list[int] = []
        self.emitted = 0  # samples already returned
        self._prev_win: np.ndarray | None = None
        self._prev_start = 0
        self.sample_rate = pipeline.sample_rate
        # pluggable decode with pipeline.synthesize's signature (a server's
        # batcher can share device calls between streams)
        self._synth = synth_fn or pipeline.synthesize
        # first-feed priority: a synth_fn that takes ``priority`` (the
        # server's codec micro-batcher) runs the TTFA-critical first decode
        # ahead of other streams' steady feeds
        try:
            self._synth_priority = "priority" in inspect.signature(self._synth).parameters
        except (TypeError, ValueError):
            self._synth_priority = False

    def _decode_window(self, start: int, need: int) -> tuple[np.ndarray, int]:
        """Decode the current prefix; return (win, n_total): ``win`` covers
        [start, start + len(win)) of the decode and ``n_total`` is its count
        of valid samples. Brings back one fixed window unless the caller
        needs more than a window (then the full decode)."""
        first = {"priority": True} if self._synth_priority and self.emitted == 0 else {}
        if need + self.crossfade > self.window:
            result = self._synth(self.codes, self.embedding, interp_anchor=self.INTERP_ANCHOR,
                                 peak_normalize=False, **first)
            total = int(result.audio.size)
            return np.asarray(result.audio[start:], np.float32), total
        kw = {"pcm16": True, **first} if self.transfer_pcm16 else first
        result = self._synth(self.codes, self.embedding, interp_anchor=self.INTERP_ANCHOR,
                             peak_normalize=False, window=(start, self.window), **kw)
        total = (result.n_total if result.n_total is not None
                 else int(start + result.audio.size))
        return np.asarray(result.audio, np.float32), int(total)

    def _emit(self, win: np.ndarray, start: int, n_total: int, upto: int) -> np.ndarray:
        """Emit [self.emitted, upto) from ``win`` (which covers the decode
        from ``start``), crossfading against the previous window around the
        boundary."""
        upto = min(upto, n_total, start + win.size)
        if upto <= self.emitted:
            self._prev_win, self._prev_start = win, start
            return np.zeros(0, np.float32)
        out = win[self.emitted - start: upto - start].copy()
        if self._prev_win is not None and self.crossfade > 0 and self.emitted > 0:
            off = self.emitted - self._prev_start
            n = min(self.crossfade, out.size, max(0, self._prev_win.size - off))
            if n > 0 and off >= 0:
                t = np.arange(n, dtype=np.float32) / n
                fade = 0.5 - 0.5 * np.cos(np.pi * t)  # 0 -> 1
                prev = self._prev_win[off:off + n]
                out[:n] = prev * (1.0 - fade) + out[:n] * fade
        self.emitted = upto
        self._prev_win, self._prev_start = win, start
        return out

    def feed(self, new_codes: list[int]) -> np.ndarray:
        """Append codes; return newly stabilized samples (may be empty)."""
        self.codes.extend(int(c) for c in new_codes)
        n = len(self.codes)
        stable_tokens = n - self.lookahead
        if n < self.min_decode or stable_tokens <= 0:
            return np.zeros(0, np.float32)
        stable_samples = stable_tokens * self.pipeline.samples_per_token
        if stable_samples <= self.emitted:
            return np.zeros(0, np.float32)
        start = self.emitted
        win, n_total = self._decode_window(start, stable_samples - start)
        return self._emit(win, start, n_total, stable_samples)

    def finalize(self) -> np.ndarray:
        """Flush: decode the full sequence and emit everything left."""
        if not self.codes:
            return np.zeros(0, np.float32)
        start = self.emitted
        need = max(0, len(self.codes) * self.pipeline.samples_per_token - start)
        win, n_total = self._decode_window(start, need)
        return self._emit(win, start, n_total, n_total)


def stream_text_to_audio(pipeline: MioTTSPipeline, llm_engine, text: str,
                         embedding: np.ndarray | None, n_predict: int = 700, n_ctx: int = 700,
                         sampler=None, lookahead_tokens: int = 8,
                         on_audio=None, on_token=None):
    """Chunked LLM generation interleaved with incremental synthesis. Calls
    on_audio(np.ndarray) per stable PCM chunk and on_token(tok, i, eog) per
    token (which may return False to cancel); codes are fed CHUNK at a
    time. Returns (audio, n_codes)."""
    ss = StreamingSynthesizer(pipeline, embedding, lookahead_tokens=lookahead_tokens)
    pieces: list[np.ndarray] = []
    pending: list[int] = []

    def emit(pcm: np.ndarray) -> None:
        if pcm.size:
            pieces.append(pcm)
            if on_audio is not None:
                on_audio(pcm)

    def handle(tok, index, is_eog):
        if on_token is not None and not on_token(tok, index, is_eog):
            return False
        code = llm_engine.token_to_code_or_none(tok)
        if code is not None:
            pending.append(code)
        if len(pending) >= CHUNK:
            pcm = ss.feed(pending)
            pending.clear()
            emit(pcm)
        return True

    llm_engine.generate_audio_tokens_streaming(text, handle, n_predict=n_predict, n_ctx=n_ctx,
                                               sampler=sampler)
    if pending:
        emit(ss.feed(pending))
        pending.clear()
    emit(ss.finalize())
    audio = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
    return audio, len(ss.codes)
