"""The kernel wrappers' launch counters across CUDA graph captures and
replays, and the capture check of first-use caches.

Each wrapper (``ops/cuda/*.py``) adds one to its module's ``launches``
when Python calls it, and a replay calls no Python. So a graph module
(``models/decode_graph.py``, ``models/codec_graph.py``) records the
launches its capture made, takes them back (the capture ran nothing), and
adds them again on every replay: a wrapper's ``launches`` stays the number
of its kernel's launches in this process.
"""

from __future__ import annotations

import contextlib

import torch


def kernel_modules() -> tuple:
    """The six kernel wrapper modules, K1-K6."""
    from . import activation1d, banded_attention, conv1d, decode_attention, q8_matmul, resblock
    return (banded_attention, decode_attention, q8_matmul, conv1d, activation1d, resblock)


@contextlib.contextmanager
def record_launches():
    """Around a capture: yields a dict that, on exit, maps each kernel
    module to the launches made inside, and puts every counter back."""
    before = {m: m.launches for m in kernel_modules()}
    per_replay: dict = {}
    try:
        yield per_replay
    finally:
        for m, n in before.items():
            per_replay[m] = m.launches - n
            m.launches = n


def count_replay(per_replay: dict) -> None:
    """After a replay: count the launches the graph ran."""
    for m, n in per_replay.items():
        m.launches += n


def capturing() -> bool:
    """True while the current CUDA stream is being captured into a graph.
    A cache that would fill an entry now must refuse: the value would be a
    graph-pool tensor that nothing ever wrote."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
