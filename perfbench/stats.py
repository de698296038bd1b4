"""Statistics over a window's requests, the same for every metric that reads them."""

from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float | None:
    """The q-th percentile (0-100), linear between order statistics as
    numpy's default; a failed request enters as infinity, so a percentile
    that reaches one is None, as is one of no values."""
    if not values:
        return None
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(v[hi]) or math.isinf(v[lo]):
        return None
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def latencies_ms(w, streams_only: bool = False, first_audio: bool = False) -> list[float]:
    """Every attempted request's time from due to its last (or, with
    ``first_audio``, its first) audio, in ms; infinity for one that failed."""
    out = []
    for r in w.requests:
        if streams_only and not r.stream:
            continue
        rec = w.records.get(r.i)
        if not rec or not rec.get("ok"):
            out.append(math.inf)
        else:
            out.append((rec["first_audio" if first_audio else "done"] - rec["due"]) * 1e3)
    return out


def generated(rec: dict) -> int:
    """Tokens a finished request generated: a stream's token events, a
    /mio/tts answer's code count."""
    return len(rec["tokens"]) if rec["stream"] else int(rec["n_codes"])


def llm_interval(rec: dict) -> tuple[float, float]:
    """When a finished request's tokens were generated, as far as the
    client can tell: a /mio/tts answer's llm_ms before its synth_ms; a
    stream from its send to its last audio (its codec work interleaves)."""
    if rec["stream"]:
        return rec["sent"], rec["done"]
    end = rec["done"] - rec["synth_ms"] / 1e3
    return end - rec["llm_ms"] / 1e3, end


def synth_interval(rec: dict) -> tuple[float, float]:
    """When a finished request's codec work ran (see ``llm_interval``)."""
    if rec["stream"]:
        return rec["sent"], rec["done"]
    return rec["done"] - rec["synth_ms"] / 1e3, rec["done"]
