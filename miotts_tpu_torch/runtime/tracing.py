"""Tracing/profiling helpers (miotts_tpu/runtime/tracing.py) on
``torch.profiler``.

The per-phase timings stay in the fixed stderr lines and the server's
fields; deep profiling is a ``torch.profiler`` trace:

- set ``MIOTTS_PROFILE_DIR=/path`` to capture one trace a process, started
  by the first ``maybe_start_profiler`` (``pipeline.synthesize`` and the
  server's batcher call it). It records the host ops and ranges of every
  thread (``profile_all_threads`` where this torch has it) and, on CUDA,
  every kernel the card runs, whoever launched it.
- ``trace_phase(name)`` names a phase in the trace: a
  ``torch.profiler.record_function`` range and, on CUDA, an NVTX range.
  With no profiler running it does nothing.

``jax.profiler.start_trace`` writes its trace at ``stop_trace``; so does
this module (``stop_profiler`` writes ``<dir>/miotts_<pid>.pt.trace.json``,
a Chrome trace), and ``maybe_start_profiler`` registers ``stop_profiler``
with ``atexit``, so a process that ends normally leaves its trace on disk
even when nothing stopped the profiler by name.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import threading

import torch

_profiler = None
_path: str | None = None
_lock = threading.Lock()


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


def maybe_start_profiler() -> bool:
    """Start a ``torch.profiler`` trace once a process when
    MIOTTS_PROFILE_DIR is set. Returns True if a trace is running."""
    global _profiler, _path
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
    return True


def stop_profiler() -> str | None:
    """Stop the trace and write it; returns the trace's path, or None when
    no trace was running."""
    global _profiler
    with _lock:
        prof, _profiler = _profiler, None
        if prof is None:
            return None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(_path)
        return _path


@contextlib.contextmanager
def trace_phase(name: str):
    """Annotate a host phase in profiler traces: this module's trace, or a
    profiler the calling thread runs (nothing when neither records)."""
    if _profiler is None and not torch.autograd._profiler_enabled():
        yield
        return
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
