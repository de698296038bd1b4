"""One codec decode captured as a CUDA graph and replayed.

The JAX pipeline compiles ``codec_synthesize`` once per (bucket,
``interp_anchor_tokens``, ``peak_normalize``) (miotts_tpu/pipeline.py:
155-159). Its CUDA counterpart here: the pipeline's decode body
(``codec_synthesize``, the window slice and the packing of the result for
one host read; ``pipeline.py``) captured once into a ``torch.cuda.CUDAGraph``
on static input buffers, then replayed, with no Python per op.

- The graph keeps its static input buffers (``inputs``: tokens, lengths,
  cond, window starts) for its whole life. ``run`` copies a request's host
  arrays into them whole (the zeros past each length included), replays,
  and brings the one packed output back with one host read.
- Warm-up: the body first runs once eagerly on the capture stream, with
  ``check_syncs`` under ``torch.cuda.set_sync_debug_mode("error")`` so that
  a hidden host sync fails there and not as a wrong replay
  (``run_checked``). That mode is global to the process, so only a caller
  whose thread alone drives the card (the CLI, tests, ``chip_smoke.py``)
  asks for it; a server, whose other threads read results from the card
  meanwhile, runs its warm-ups plain. It fills what a
  capture cannot: the julius filters and K5/K6's permuted operands (both
  refuse to fill during capture), the kernels' attributes, cuDNN's plans
  and the stream's cuBLAS workspace, and it gives the capturing thread
  its own cuBLAS and cuDNN handles (one created during a capture breaks
  it). A caller that has just run that eager body on that stream with the
  same shapes on the same thread (the pipeline's first decode of a key)
  passes ``warm_up=False``.
- Memory: the codec graphs of one pipeline share one memory pool
  (``pool``), and its reference graphs another. That is sound because the
  replays of one pool's graphs run one at a time on one stream (a lock of
  the pipeline's holds copy-in, replay and the host read together) and the
  pipeline copies each output to the host before the next replay. So a
  graph's ``out`` is valid only until the next replay of any graph of its
  pool.
- The capture runs in ``graphs.CAPTURE_MODE`` ("thread_local"): other
  threads' device work goes on while one thread captures. The warm-up,
  the capture and the device-wide synchronizes around them hold
  ``graphs.capture_lock(device)``, as a chunk graph's do: a device-wide
  synchronize while another thread captures fails and breaks that capture.
- A failed capture raises; nothing falls back to eager decodes.

Counters (``Counters``, one set a kind of graph at module level: ``codec``
for the pipeline's codec decodes, ``reference`` for its reference chains;
a caller may reset them): ``captures``, ``capture_ms`` (host time of the
warm-ups and captures), ``replays``, ``replay_ms`` (host time of ``run``:
copy-in, replay and the host read) and ``eager`` (runs of the body eager
on a CUDA device: the pipeline's first run of each key, and those asked
for by name). Each kernel wrapper's ``launches`` counts the launches of
replays too (``ops/cuda/graphs.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..device import to_device, to_host
from ..ops.cuda import graphs
from ..runtime import tracing


@dataclasses.dataclass
class Counters:
    """The routes runs of one kind of graph took."""
    captures: int = 0
    replays: int = 0
    capture_ms: float = 0.0
    replay_ms: float = 0.0
    eager: int = 0


codec = Counters()
reference = Counters()


def run_checked(body: Callable, inputs: dict[str, torch.Tensor],
                check_syncs: bool = True) -> torch.Tensor:
    """body(inputs) run eagerly on the card; with ``check_syncs`` any host
    sync (of any thread, the mode being the process's) is an error."""
    if not check_syncs:
        return body(inputs)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return body(inputs)
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class CodecGraph:
    """``body(inputs) -> out`` captured on ``inputs``, the graph's static
    buffers, on ``stream`` and in the memory pool ``pool`` (None: a pool of
    its own); ``check_syncs`` as in ``run_checked``; its captures and
    replays count into ``counters``."""

    def __init__(self, body: Callable, inputs: dict[str, torch.Tensor],
                 stream: torch.cuda.Stream, pool=None, warm_up: bool = True,
                 check_syncs: bool = True, counters: Counters = codec):
        dev = next(iter(inputs.values())).device
        if dev.type != "cuda":
            raise ValueError(f"a codec graph needs a CUDA device, not {dev}")
        t0 = time.perf_counter()
        self.inputs = inputs
        # the device-wide synchronizes run under the capture lock, as the
        # capture does: one while another thread captures fails and breaks
        # that capture
        with graphs.capture_lock(dev):
            if warm_up:
                stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(stream):
                    run_checked(body, inputs, check_syncs)
            torch.cuda.synchronize(dev)
            self.graph = torch.cuda.CUDAGraph()
            with graphs.record_launches() as self.launches_per_replay, \
                    torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                     capture_error_mode=graphs.CAPTURE_MODE):
                self.out = body(inputs)
            torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.n_replays = 0
        self.counters = counters
        counters.captures += 1
        counters.capture_ms += self.capture_ms

    def replay(self) -> torch.Tensor:
        """One replay on the current stream; returns ``out``."""
        self.graph.replay()
        graphs.count_replay(self.launches_per_replay)
        self.n_replays += 1
        self.counters.replays += 1
        return self.out

    def run(self, host: dict[str, np.ndarray]) -> np.ndarray:
        """Copy ``host``'s arrays into the input buffers of the same names
        (each rewritten whole), replay, and return ``out`` on the host."""
        t0 = time.perf_counter()
        with tracing.on_device():
            for name, value in host.items():
                self.inputs[name].copy_(to_device(value, self.inputs[name].device))
            out = self.replay()
        out = to_host(out)
        self.counters.replay_ms += (time.perf_counter() - t0) * 1e3
        return out
