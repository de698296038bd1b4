"""The kernel wrappers' launch counters across CUDA graph captures and
replays, and the capture check of first-use caches.

Each wrapper (``ops/cuda/*.py``) calls ``launched`` where it launches its
kernel, and a replay calls no Python. A counter is a kernel module's
``launches`` (K1-K6) or a fused kernel's (``llm_fused.KERNELS``, K7-K10;
``llm_gemv.KERNELS``, the K11 family),
named by its ``__name__`` (``counters``). While a thread records a capture
(``record_launches``), its calls count into the graph's per-replay counts
and leave the module's ``launches`` alone (the capture ran nothing); the
graph module (``models/decode_graph.py``, ``models/codec_graph.py``) adds
them on every replay. Other threads' launches meanwhile count as usual,
so a wrapper's ``launches`` stays the number of its kernel's launches in
this process while a server's threads share the card.

Captures run in ``CAPTURE_MODE`` "thread_local": a call that is unsafe
during a capture (a host sync, ``cudaMalloc`` outside the caching
allocator) fails only when the capturing thread makes it, so other
threads' device work goes on while one thread captures. Two calls still
reach a capture from another thread: a device-wide synchronize (it fails,
and the capture breaks), and the free of a pinned host buffer last copied
on the capturing stream (PyTorch records the buffer's event on that
stream then, into the capture; ``device.to_host`` frees its buffer at
once, under the caller's lock). ``capture_lock`` keeps two captures from
overlapping each other, and the device-wide synchronizes around a
capture run under it.

That holds only while no other thread works on the stream being
captured. PyTorch hands out its streams round robin from a pool of 32 a
priority, so a stream made for one capture can be the very stream that a
server's worker or prefill thread runs on: the capture then takes in
that thread's work, and its event calls fail. A chunk graph's warm-up
and capture therefore run on ``capture_stream``, one stream a device from
the high-priority pool, from which no other stream of the port comes; a
codec graph captures on its pipeline's own stream, which only the
pipeline's lock holder uses.

Both the lock and the capture stream are kept for each device: a capture
and the device-wide synchronizes around it concern its own card only.

Launches by rank. On a mesh (``parallel/``) a tensor-parallel forward runs
each rank's part inside ``on_rank(rank id)``, and every launch there
counts once more, in ``rank_launches[(module name, rank id)]`` (in a
graph's per-replay counts while a capture records), so the launches of
each logical rank can be told apart when several share one card.
"""

from __future__ import annotations

import contextlib
import threading

import torch

CAPTURE_MODE = "thread_local"

_tls = threading.local()
_lock = threading.Lock()
_capture_streams: dict = {}
_capture_locks: dict = {}
_by_name: dict = {}  # counters by __name__, filled at first launch
# launches a logical rank made, by (kernel module name, rank id); callers
# may clear it
rank_launches: dict = {}


def _index(device: torch.device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def capture_lock(device: torch.device) -> threading.Lock:
    """The lock that keeps two captures on ``device`` (and the device-wide
    synchronizes around them) from overlapping."""
    index = _index(device)
    with _lock:
        return _capture_locks.setdefault(index, threading.Lock())


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream chunk graphs warm up and capture on: one a device, from
    the high-priority pool (the port's other streams are all made at the
    default priority). Use it under ``capture_lock(device)``."""
    index = _index(device)
    with _lock:
        stream = _capture_streams.get(index)
        if stream is None:
            stream = _capture_streams[index] = torch.cuda.Stream(index, priority=-1)
        return stream


def kernel_modules() -> tuple:
    """The six kernel wrapper modules, K1-K6."""
    from . import activation1d, banded_attention, conv1d, decode_attention, q8_matmul, resblock
    return (banded_attention, decode_attention, q8_matmul, conv1d, activation1d, resblock)


def counters() -> tuple:
    """Every launch counter: the six kernel modules and the fused kernels
    K7-K11, each with its ``__name__`` and ``launches``."""
    from . import llm_fused, llm_gemv
    return kernel_modules() + llm_fused.KERNELS + llm_gemv.KERNELS


def _counter(name: str):
    c = _by_name.get(name)
    if c is None:
        c = _by_name[name] = next(c for c in counters() if c.__name__ == name)
    return c


def launched(module_name: str) -> None:
    """A wrapper launched its kernel: count it in the counter of that name
    (a module's or a fused kernel's ``launches``; inside ``on_rank``, also
    in ``rank_launches``), or, while this thread records a capture, in the
    graph's counts."""
    rank = getattr(_tls, "rank", None)
    rec = getattr(_tls, "recording", None)
    if rec is not None:
        rec[module_name] = rec.get(module_name, 0) + 1
        if rank is not None:
            rec[(module_name, rank)] = rec.get((module_name, rank), 0) + 1
        return
    with _lock:
        _counter(module_name).launches += 1
        if rank is not None:
            rank_launches[(module_name, rank)] = rank_launches.get((module_name, rank), 0) + 1


@contextlib.contextmanager
def on_rank(rank: int | None):
    """Launches in this thread count for logical rank ``rank`` meanwhile
    (None: for no rank)."""
    prev = getattr(_tls, "rank", None)
    _tls.rank = rank
    try:
        yield
    finally:
        _tls.rank = prev


@contextlib.contextmanager
def record_launches():
    """Around a capture in this thread: yields a dict that, on exit, maps
    each counter (``counters``) to the launches made inside."""
    per_replay: dict = {}
    _tls.recording = rec = {}
    try:
        yield per_replay
    finally:
        _tls.recording = None
        for m in counters():
            per_replay[m] = rec.get(m.__name__, 0)
        per_replay.update((k, n) for k, n in rec.items() if isinstance(k, tuple))


def count_replay(per_replay: dict) -> None:
    """After a replay: count the launches the graph ran (a rank's too)."""
    with _lock:
        for m, n in per_replay.items():
            if isinstance(m, tuple):
                rank_launches[m] = rank_launches.get(m, 0) + n
            else:
                m.launches += n


def capturing() -> bool:
    """True while the current CUDA stream is being captured into a graph.
    A cache that would fill an entry now must refuse: the value would be a
    graph-pool tensor that nothing ever wrote."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
