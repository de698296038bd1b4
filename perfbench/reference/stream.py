"""What a streamed request's audio should be: the server's feed schedule
and stitching, replayed over plain reference decodes.

A frozen copy of the rules of the port's ``StreamingSynthesizer`` and of
its server's feed policy (``run_streaming_request``): the first feed once
``lookahead + 4`` codes are in, then one every 16 codes, then a final
flush; each feed re-decodes the whole prefix with the resize ratio pinned
to a 1 024-token anchor, without peak normalization, brings back one
32 768-sample window quantized to 16 bits, and emits the samples more than
``lookahead`` tokens behind the prefix end, with a raised-cosine crossfade
of 128 samples against the previous window. The SSE events carry each
emission as 16-bit PCM.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

LOOKAHEAD, CROSSFADE, MIN_DECODE, WINDOW, ANCHOR, TOKEN_CHUNK = 8, 128, 4, 32768, 1024, 16


def pcm16(x: np.ndarray) -> np.ndarray:
    """f32 -> int16 as the server quantizes: clip to [-1, 1], x 32767, round half to even."""
    return np.rint(np.clip(x.astype(np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)


def stream_pcm(decode: Callable[[list[int]], np.ndarray], codes: list[int], spt: int) -> np.ndarray:
    """The int16 samples a stream of ``codes`` delivers; ``decode(prefix)``
    is the f32 decode of a prefix (anchored, not peak-normalized)."""
    fed: list[int] = []
    pieces: list[np.ndarray] = []
    state = {"emitted": 0, "prev": None, "prev_start": 0}

    def window(start: int, need: int) -> tuple[np.ndarray, int]:
        audio = decode(fed)
        total = int(audio.size)
        if need + CROSSFADE > WINDOW:
            return audio[start:].astype(np.float32), total
        win = audio[start:min(start + WINDOW, total)]
        return pcm16(win).astype(np.float32) / np.float32(32767.0), total

    def emit(win: np.ndarray, start: int, total: int, upto: int) -> None:
        emitted, prev = state["emitted"], state["prev"]
        upto = min(upto, total, start + win.size)
        if upto > emitted:
            out = win[emitted - start:upto - start].copy()
            if prev is not None and emitted > 0:
                off = emitted - state["prev_start"]
                n = min(CROSSFADE, out.size, max(0, prev.size - off))
                if n > 0 and off >= 0:
                    t = np.arange(n, dtype=np.float32) / n
                    fade = 0.5 - 0.5 * np.cos(np.pi * t)
                    out[:n] = prev[off:off + n] * (1.0 - fade) + out[:n] * fade
            state["emitted"] = upto
            if out.size:
                pieces.append(pcm16(out))
        state["prev"], state["prev_start"] = win, start

    def feed(new: list[int]) -> None:
        fed.extend(new)
        stable = len(fed) - LOOKAHEAD
        if len(fed) < MIN_DECODE or stable <= 0 or stable * spt <= state["emitted"]:
            return
        start = state["emitted"]
        win, total = window(start, stable * spt - start)
        emit(win, start, total, stable * spt)

    pending: list[int] = []
    for c in codes:
        pending.append(c)
        if len(pending) >= TOKEN_CHUNK or (
                state["emitted"] == 0 and len(fed) + len(pending) >= LOOKAHEAD + 4):
            feed(pending)
            pending = []
    if pending:
        feed(pending)
    if fed:
        start = state["emitted"]
        win, total = window(start, max(0, len(fed) * spt - start))
        emit(win, start, total, total)
    return np.concatenate(pieces) if pieces else np.zeros(0, np.int16)
