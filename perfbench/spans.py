"""The program's own spans over a whole window (``runtime/tracing.py``'s
recorder in ``miotts_tpu_torch``), for the readers of the per-layer metrics
that read them (``metrics/<name>.py``): a window's spans are
``Window.spans``, a list of ``WSpan`` in seconds from the window's opening,
or absent (a window run without the recorder, or a program without one),
which every reader reads as nothing: None.

``recorded_window`` runs one window of the harness (``Bench.window``) with
the recorder on from before the load generator starts until its last
answer, and keeps on the window the spans whose start lies inside it
(``spans``) and what the recorder counted (``recorder``): the spans it
held, those its ring dropped, and the drift between the card's clock and
the host's over the recording.
"""

from __future__ import annotations

import json
from typing import NamedTuple

from .trace import merged, union

# the host ranges an idle gap of the device is put down to (``idle_by_host``)
HOST = ("prefill_group", "attach", "chunk_dispatch", "chunk_fetch", "chunk_deliver",
        "codec_group")


class WSpan(NamedTuple):
    name: str
    start: float  # seconds from the window's opening
    end: float
    thread: str
    sid: int
    parent: int | None
    rids: tuple
    attrs: dict


def spans_of(w, name: str | None = None, prefix: str | None = None) -> list[WSpan]:
    """The window's spans of ``name`` (or whose name starts with
    ``prefix``); [] when the window has none."""
    spans = getattr(w, "spans", None) or []
    if name is not None:
        return [s for s in spans if s.name == name]
    return [s for s in spans if s.name.startswith(prefix)]


def window_spans(spans, start_at: float, seconds: float) -> list[WSpan]:
    """The program's spans (``start_ns``/``end_ns`` on CLOCK_MONOTONIC)
    whose start lies in [start_at, start_at + seconds] (``start_at`` in
    ``time.monotonic()`` seconds), in window seconds."""
    t0 = start_at * 1e9
    out = []
    for s in spans:
        a = (s.start_ns - t0) / 1e9
        if 0.0 <= a <= seconds:
            out.append(WSpan(s.name, a, (s.end_ns - t0) / 1e9, s.thread, s.sid, s.parent,
                             tuple(s.rids), dict(s.attrs)))
    return out


def device_busy(w) -> list[tuple[float, float]]:
    """The window's device intervals, clipped to it."""
    return [(max(0.0, s.start), min(w.seconds, s.end)) for s in spans_of(w, prefix="device:")
            if s.end > 0.0 and s.start < w.seconds]


def idle_by_host(w, top: int = 10) -> list[list]:
    """The window's device idle time (outside every device interval) put
    down to the host range (``HOST``) that covered each gap's middle, the
    shortest of those that did ("none" where none did), as [name,
    seconds], most first."""
    hosts = [s for s in getattr(w, "spans", None) or [] if s.name in HOST]
    out: dict[str, float] = {}
    end = 0.0
    gaps = []
    for a, b in merged(device_busy(w)):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if end < w.seconds:
        gaps.append((end, w.seconds))
    for a, b in gaps:
        mid = (a + b) / 2
        cover = [s for s in hosts if s.start <= mid <= s.end]
        name = min(cover, key=lambda s: s.end - s.start).name if cover else "none"
        out[name] = out.get(name, 0.0) + (b - a)
    return sorted(([n, v] for n, v in out.items()), key=lambda x: -x[1])[:top]


def busy_seconds(w) -> float:
    return union(device_busy(w))


def recorded_window(bench, reqs, seconds: float, **kw):
    """``bench.window(reqs, seconds, **kw)`` with the program's recorder on
    around it; the window gains ``spans`` and ``recorder``. A program
    without the recorder runs the window as it is, with neither."""
    from miotts_tpu_torch.runtime import tracing

    if not hasattr(tracing, "recording"):
        return bench.window(reqs, seconds, **kw)
    with tracing.recording() as rec:
        w = bench.window(reqs, seconds, **kw)
    spans = rec.collect()
    spec = json.loads((bench.run_dir / f"window{bench.n_windows}" / "spec.json").read_text())
    w.spans = window_spans(spans, spec["start_at"], seconds)
    w.recorder = {"spans": len(spans), "in_window": len(w.spans), "dropped": rec.dropped,
                  "clock_drift_ns": rec.clock_drift_ns}
    return w
