"""Tracing/profiling helpers (miotts_tpu/runtime/tracing.py) on
``torch.profiler``, and the port's own span recorder.

The per-phase timings stay in the fixed stderr lines and the server's
fields; deep profiling is a ``torch.profiler`` trace:

- set ``MIOTTS_PROFILE_DIR=/path`` to capture one trace a process, started
  by the first ``maybe_start_profiler`` (``pipeline.synthesize`` and the
  server's batcher call it). It records the host ops and ranges of every
  thread (``profile_all_threads`` where this torch has it) and, on CUDA,
  every kernel the card runs, whoever launched it.
- ``trace_phase(name, **attrs)`` names a phase: while a profiler runs
  (this module's, or one the calling thread runs) a
  ``torch.profiler.record_function`` range and, on CUDA, an NVTX range,
  whose text is the name and then ``key=value`` for each attribute
  (``chunk_dispatch steps=16 width=8 live=3``); while the recorder runs, a
  span. With neither it tests one flag (and asks torch whether the caller
  runs a profiler), and reads no clock.

``jax.profiler.start_trace`` writes its trace at ``stop_trace``; so does
this module (``stop_profiler`` writes ``<dir>/miotts_<pid>.pt.trace.json``,
a Chrome trace), and ``maybe_start_profiler`` registers ``stop_profiler``
with ``atexit``, so a process that ends normally leaves its trace on disk
even when nothing stopped the profiler by name.

**The recorder** (``start_recording``/``stop_recording``, ``recording()``;
``MIOTTS_SPAN_DIR=/path`` switches it on at ``maybe_start_profiler`` and
writes ``<dir>/miotts_<pid>.spans.json``, a Chrome trace, at exit) keeps
spans in memory, in a ring of ``capacity`` (65 536) that drops its oldest
span when full and counts the drops; its ``collect`` drains it. A ``Span`` has
a name, ``start_ns``/``end_ns`` on ``time.monotonic_ns`` (CLOCK_MONOTONIC,
one clock for every process of the machine), its thread, its id
(``sid``), the id of the span that caused it (``parent``), the ids of the
requests it served (``rids``) and its attributes.

- Request ids come from ``new_id``, the same counter as span ids: a
  request's root span (``request_span``) has its request's id as its own,
  so every span of one request, on any thread, names it as ``parent``.
- A span's parent is the innermost open span of its thread, else its
  request (``rid``); it serves ``rids``, else its parent's requests.
- ``record(name, start_ns, end_ns, ...)`` adds a span whose start lies in
  the past (a queue wait, timed with stamps its owner keeps anyway);
  ``now_ns()`` reads the clock only while the recorder runs.
- ``profiled=False`` keeps a span out of the profiler: only the ranges
  that traces were read by before the recorder existed go there, with the
  text they had; ``tags`` are attributes the recorder keeps and the
  profiler's text leaves out.
- Device intervals: inside ``on_device()`` the current stream records a
  pair of timing CUDA events around the work while the recorder runs (no
  events otherwise); ``resolve_device()``, called once the host has read
  that work's result (its events are complete by then: no synchronize on
  the hot path), turns each completed pair into a span named
  ``device:<the innermost open span at on_device>``, caused by that span
  and with its requests and attributes. Event times map onto
  ``monotonic_ns`` through an anchor a device taken at ``start_recording``
  (an event recorded on an idle stream of its own and waited for, the
  host clock read around it); ``stop_recording`` anchors again and reports
  the drift between the two clocks (``clock_drift_ns``). No anchor
  synchronizes the device: a device-wide synchronize breaks another
  thread's graph capture.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

_profiler = None
_path: str | None = None
_lock = threading.Lock()
# trace_phase's one flag: the recorder runs or this module's profiler does
_active = False
_recorder: "Recorder | None" = None
_ids = itertools.count(1)  # request and span ids: one counter
_tls = threading.local()  # .stack: the thread's open recorder spans
CAPACITY = 65536


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _new_profiler():
    try:
        from torch._C._profiler import _ExperimentalConfig

        return torch.profiler.profile(
            activities=_activities(),
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):  # a torch without the option: this thread only
        return torch.profiler.profile(activities=_activities())


def _set_active() -> None:
    global _active
    _active = _recorder is not None or _profiler is not None


def maybe_start_profiler() -> bool:
    """Start a ``torch.profiler`` trace once a process when
    MIOTTS_PROFILE_DIR is set, and the recorder when MIOTTS_SPAN_DIR is
    (its spans written there at exit). Returns True if a trace is
    running."""
    global _profiler, _path
    span_dir = os.environ.get("MIOTTS_SPAN_DIR")
    if span_dir and _recorder is None:
        start_recording()
        atexit.register(_write_at_exit, span_dir)
    trace_dir = os.environ.get("MIOTTS_PROFILE_DIR")
    if not trace_dir:
        return False
    with _lock:
        if _profiler is None:
            os.makedirs(trace_dir, exist_ok=True)
            prof = _new_profiler()
            prof.start()
            _profiler = prof
            _path = os.path.join(trace_dir, f"miotts_{os.getpid()}.pt.trace.json")
            atexit.register(stop_profiler)
            _set_active()
    return True


def stop_profiler() -> str | None:
    """Stop the trace and write it; returns the trace's path, or None when
    no trace was running."""
    global _profiler
    with _lock:
        prof, _profiler = _profiler, None
        _set_active()
        if prof is None:
            return None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(_path)
        return _path


# -- the recorder ------------------------------------------------------------------


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: str
    sid: int
    parent: int | None
    rids: tuple
    attrs: dict


class Recorder:
    """The spans of one recording: a ring of ``capacity`` spans (the oldest
    dropped and counted when full), the device intervals waiting for their
    events, and each device's clock anchors."""

    def __init__(self, capacity: int = CAPACITY):
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.clock_drift_ns: int | None = None  # set at stop_recording
        # the widest host-clock window an anchor was taken in (its error is
        # at most half of it)
        self.anchor_window_ns: int | None = None
        self._lock = threading.Lock()
        self._pending: list[tuple] = []  # (Span fields but times, start event, end event)
        self._anchors: dict[int, tuple] = {}  # device index -> (event, monotonic ns)

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(span)

    def collect(self) -> list[Span]:
        """The spans recorded so far, oldest first; the ring is emptied."""
        with self._lock:
            out = list(self.spans)
            self.spans.clear()
        return out

    def resolve(self, wait: bool = False) -> None:
        """Device intervals whose end event has completed (every one, with
        ``wait``: each end event waited for) become spans."""
        with self._lock:
            pending, self._pending = self._pending, []
        keep = []
        for name, thread, parent, rids, attrs, dev, ev0, ev1 in pending:
            if wait:
                ev1.synchronize()
            elif not ev1.query():
                keep.append((name, thread, parent, rids, attrs, dev, ev0, ev1))
                continue
            anchor, ns = self._anchors[dev]
            self.add(Span(name, ns + int(anchor.elapsed_time(ev0) * 1e6),
                          ns + int(anchor.elapsed_time(ev1) * 1e6), thread, next(_ids), parent,
                          rids, attrs))
        if keep:
            with self._lock:
                self._pending = keep + self._pending

    def anchor_all(self) -> dict[int, tuple]:
        """Each visible CUDA device's anchor now: (event, monotonic ns)."""
        if not torch.cuda.is_available():
            return {}
        anchors = {i: _anchor(i) for i in range(torch.cuda.device_count())}
        self.anchor_window_ns = max([self.anchor_window_ns or 0,
                                     *(w for _, _, w in anchors.values())])
        return {i: (ev, ns) for i, (ev, ns, _) in anchors.items()}


def _anchor(device: int, tries: int = 10) -> tuple:
    """An event on an idle stream of ``device`` and the host's clock when
    the device passed it: of ``tries``, the one waited for the shortest, at
    the middle of its wait; (event, ns, the wait's ns)."""
    stream = torch.cuda.Stream(device)
    best = None
    for _ in range(tries):
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.monotonic_ns()
        ev.record(stream)
        ev.synchronize()
        t1 = time.monotonic_ns()
        if best is None or t1 - t0 < best[2]:
            best = (ev, (t0 + t1) // 2, t1 - t0)
    return best


def start_recording(capacity: int = CAPACITY) -> Recorder:
    """Switch the recorder on (a new, empty one) and anchor each device's
    clock; returns it."""
    global _recorder
    rec = Recorder(capacity)
    rec._anchors = rec.anchor_all()
    with _lock:
        _recorder = rec
        _set_active()
    return rec


def stop_recording() -> Recorder | None:
    """Switch the recorder off: its device intervals resolved (each waited
    for), each device anchored again and the largest drift between the
    two clocks over the recording kept in ``clock_drift_ns``. Returns it
    (its spans still to ``collect``), or None when none ran."""
    global _recorder
    with _lock:
        rec, _recorder = _recorder, None
        _set_active()
    if rec is None:
        return None
    rec.resolve(wait=True)
    drift = []
    for dev, (ev1, ns1) in rec.anchor_all().items():
        ev0, ns0 = rec._anchors[dev]
        drift.append((ns1 - ns0) - int(ev0.elapsed_time(ev1) * 1e6))
    rec.clock_drift_ns = max(drift, key=abs) if drift else None
    return rec


@contextlib.contextmanager
def recording(capacity: int = CAPACITY):
    """The recorder on inside the block; yields it (``collect`` its spans,
    inside or after)."""
    rec = start_recording(capacity)
    try:
        yield rec
    finally:
        if _recorder is rec:
            stop_recording()


def is_recording() -> bool:
    return _recorder is not None


def new_id() -> int:
    """A fresh request (or span) id, whether or not the recorder runs."""
    return next(_ids)


def now_ns() -> int:
    """``time.monotonic_ns()`` while the recorder runs, else 0 (no clock
    read)."""
    return time.monotonic_ns() if _recorder is not None else 0


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def record(name: str, start_ns: int, end_ns: int, *, rid: int = 0, rids: tuple = (),
           **attrs) -> None:
    """A span that started in the past, caused by its request ``rid``;
    nothing when the recorder is off."""
    rec = _recorder
    if rec is None:
        return
    rec.add(Span(name, start_ns, end_ns, threading.current_thread().name, next(_ids),
                 rid or None, tuple(rids) if rids else ((rid,) if rid else ()), attrs))


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Phase:
    __slots__ = ("name", "rid", "rids", "attrs", "tags", "profiled", "sid", "rec", "t0",
                 "parent", "range", "nvtx")

    def __init__(self, name, rid, rids, attrs, tags, profiled, sid):
        self.name, self.rid, self.rids, self.attrs, self.tags = name, rid, rids, attrs, tags
        self.profiled, self.sid = profiled, sid
        self.rec = self.range = None
        self.nvtx = False

    def __enter__(self):
        rec = self.rec = _recorder
        if rec is not None:
            stack = _stack()
            top = stack[-1] if stack else None
            self.parent = (top.sid if top is not None
                           else self.rid if self.rid and self.rid != self.sid else None)
            if not self.rids:
                self.rids = top.rids if top is not None else ((self.rid,) if self.rid else ())
            self.sid = self.sid or next(_ids)
            stack.append(self)
        if self.profiled and (_profiler is not None or torch.autograd._profiler_enabled()):
            text = " ".join([self.name, *(f"{k}={v}" for k, v in self.attrs.items())])
            self.range = torch.profiler.record_function(text)
            self.range.__enter__()
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_push(text)
                self.nvtx = True
        if rec is not None:
            self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            t1 = time.monotonic_ns()
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            rec.add(Span(self.name, self.t0, t1, threading.current_thread().name, self.sid,
                         self.parent, tuple(self.rids),
                         {**self.attrs, **self.tags} if self.tags else self.attrs))
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def trace_phase(name: str, *, rid: int = 0, rids=(), tags: dict | None = None,
                profiled: bool = True, **attrs):
    """A host phase: a profiler range (unless ``profiled`` is False) and a
    recorder span, each only while it runs (module docstring)."""
    if not _active and not torch.autograd._profiler_enabled():
        return _NULL
    return _Phase(name, rid, rids, attrs, tags, profiled, 0)


def request_span(rid: int, **attrs):
    """A request's root span (``request``), whose id is the request's."""
    if not _active:
        return _NULL
    return _Phase("request", rid, (rid,), attrs, None, False, rid)


class _OnDevice:
    __slots__ = ("rec", "ev0", "stream")

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        self.stream = torch.cuda.current_stream()
        self.ev0 = torch.cuda.Event(enable_timing=True)
        self.ev0.record(self.stream)
        return self

    def __exit__(self, *exc):
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record(self.stream)
        stack = _stack()
        top = stack[-1] if stack else None
        dev = self.stream.device.index
        entry = ("device:" + (top.name if top is not None else "none"),
                 f"cuda:{dev} stream {self.stream.stream_id}",
                 top.sid if top is not None else None,
                 tuple(top.rids) if top is not None else (),
                 top.attrs if top is not None else {}, dev, self.ev0, ev1)
        with self.rec._lock:
            self.rec._pending.append(entry)
        return False


def on_device():
    """Around device work queued on the current stream: its device interval
    while the recorder runs on a CUDA machine (module docstring)."""
    rec = _recorder
    if rec is None or not rec._anchors:
        return _NULL
    return _OnDevice(rec)


def resolve_device() -> None:
    """Turn the running recorder's completed device intervals into spans."""
    rec = _recorder
    if rec is not None and rec._pending:
        rec.resolve()


def chrome_trace(spans, **other) -> dict:
    """Spans as a Chrome trace (``ts`` in microseconds of CLOCK_MONOTONIC),
    one row a thread; ``other`` goes under ``otherData``."""
    tids: dict[str, int] = {}
    events = []
    pid = os.getpid()
    for s in spans:
        tid = tids.setdefault(s.thread, len(tids) + 1)
        events.append({"name": s.name, "ph": "X", "ts": s.start_ns / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid, "tid": tid,
                       "args": {"sid": s.sid, "parent": s.parent, "rids": list(s.rids),
                                **s.attrs}})
    events += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": name}} for name, tid in tids.items()]
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"clock": "CLOCK_MONOTONIC", **other}}


def _write_at_exit(span_dir: str) -> str | None:
    rec = stop_recording()
    if rec is None:
        return None
    os.makedirs(span_dir, exist_ok=True)
    path = os.path.join(span_dir, f"miotts_{os.getpid()}.spans.json")
    with open(path, "w") as f:
        json.dump(chrome_trace(rec.collect(), dropped=rec.dropped,
                               clock_drift_ns=rec.clock_drift_ns), f)
    return path
