"""A chunk of LLM decode steps: one object on every device, run as a CUDA
graph where it is captured and as its eager body everywhere else.

The JAX package runs generation on the device as a compiled
``lax.while_loop`` (miotts_tpu/models/llm.py:775-888). Its counterpart
here: the chunk body of ``models/llm.py`` (``n_steps`` times sample ->
sampler-ring update -> ``llm_decode_step`` -> pos/done update, no early
exit) on the state the chunk keeps. ``llm.chunk`` builds every chunk and
decides, once, whether it is captured: on CUDA, unless its weights are a
tensor-parallel group over several cards. A captured chunk's body is run
once eagerly on a side stream to warm it up, its state is put back, and
it is captured into a ``torch.cuda.CUDAGraph``; every run is then one
replay, with no Python per token. A chunk that is not captured runs the
body on the same buffers. Callers hold chunks and call ``run()``.

- The chunk owns the ``GenState`` it was made on: its tensors (logits,
  KV cache, pos, ring, ring cursor, done, sampler key) are a graph's
  static buffers for the chunk's whole life. A request prefills into the
  chunk's KV cache and ``load`` copies the rest of its first state in. The
  sampler's randomness is a hash of its key (``models/sampling.py``), a
  device tensor like the rest, so a replay draws what the eager body would
  from the same state.
- The warm-up runs first-use side effects outside capture: the kernels'
  shared-memory attributes, CUDA's lazy module loading, cuBLAS workspaces.
  The warm-up and the capture both run on ``graphs.capture_stream``, under
  ``graphs.capture_lock``, both the device's.
- A tensor-parallel group whose ranks share one card (``parallel/``) is
  one graph: its state's KV cache is a tuple of the ranks' parts, each a
  static buffer like the rest.
- The chunk keeps its body, so every tensor the body closes over lives as
  long as the chunk: a replay reads them by address, and a freed one
  would be memory the allocator hands to someone else.
- Whoever makes a chunk keeps it: ``LLMEngine`` keeps one for its
  weights, the server's ``ContinuousBatcher`` one for each chunk size and
  width over one shared state, and one for each fused group size.
- The capture runs in ``graphs.CAPTURE_MODE`` ("thread_local"), so a
  server's other threads may use the card meanwhile. The warm-up clones
  the state, runs the body on it and restores it; with ``warm_state`` (a
  callable that makes a throwaway state of the same shapes, called only
  for a capture) it runs on that instead and leaves ``state`` untouched.
  A capture executes nothing, so only the latter may run while another
  thread replays graphs on ``state``, as a server's background warm-up
  does.

Counters: each kernel wrapper's ``launches`` stays the number of its
kernel's launches in this process, replays counted (``ops/cuda/graphs.py``).
``captures``, ``replays``, ``capture_ms`` (host time of the
warm-ups and captures), ``warmup_steps`` (eager steps run before a capture,
their results discarded) and ``eager_steps`` (chunk steps run eagerly on a
CUDA device: a tensor-parallel group's over several cards, or a check's
``run_eager``) are module counters a caller may reset.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from ..ops.cuda import graphs

captures = 0
replays = 0
capture_ms = 0.0
warmup_steps = 0
eager_steps = 0


def _tensors(state) -> dict[str, torch.Tensor]:
    """The state's tensors by name; a tuple field (a tensor-parallel KV
    cache) by ``name.i``."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, tuple):
            out.update((f"{f.name}.{i}", t) for i, t in enumerate(v))
        else:
            out[f.name] = v
    return out


class Chunk:
    """``n_steps`` steps of ``body`` on ``state``, which the chunk keeps as
    ``.state``. ``body(state, out, n_new)`` is the eager chunk body; it
    reads and writes ``state``'s tensors in place and writes the chunk's
    tokens into ``out`` [B, n_steps] and the count of each lane's new
    tokens into ``n_new`` [B], the chunk's own buffers. With ``capture``
    (``state`` on CUDA) the body is captured as a CUDA graph here;
    ``warm_state()``, if given, makes the state its warm-up runs on."""

    def __init__(self, body: Callable, state, n_steps: int, *, capture: bool,
                 warm_state: Callable | None = None):
        self.state = state
        self.n_steps = n_steps
        # a replay reads the tensors the body closes over (a sampler's or a
        # budget's static buffers) by address: the chunk keeps the body, and
        # with it those tensors, alive as long as itself
        self.body = body
        dev = state.logits.device
        B = state.pos.shape[0]
        self.out = torch.zeros((B, n_steps), dtype=torch.int64, device=dev)
        self.n_new = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._graph = None
        self.launches_per_replay: dict = {}
        self.capture_ms = 0.0
        if capture:
            if dev.type != "cuda":
                raise ValueError(f"a chunk graph needs a CUDA device, not {dev}")
            self._capture(None if warm_state is None else warm_state())

    @property
    def captured(self) -> bool:
        """Whether a run is a replay of a captured graph."""
        return self._graph is not None

    def _capture(self, warm_state) -> None:
        global captures, capture_ms, warmup_steps
        state, body, dev = self.state, self.body, self.state.logits.device
        t0 = time.perf_counter()
        saved = (None if warm_state is not None
                 else {k: v.clone() for k, v in _tensors(state).items()})

        # the warm-up and the capture both run on the capture stream, which
        # no other thread's work reaches (graphs.capture_stream)
        with graphs.capture_lock(dev):
            stream = graphs.capture_stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                body(state if warm_state is None else warm_state, self.out, self.n_new)
            torch.cuda.current_stream(dev).wait_stream(stream)
            warmup_steps += self.n_steps
            if saved is not None:
                self._copy_in(saved)
            torch.cuda.synchronize(dev)

            graph = torch.cuda.CUDAGraph()
            with graphs.record_launches() as self.launches_per_replay, \
                    torch.cuda.graph(graph, stream=stream,
                                     capture_error_mode=graphs.CAPTURE_MODE):
                body(state, self.out, self.n_new)
            torch.cuda.synchronize(dev)
        self._graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        captures += 1
        capture_ms += self.capture_ms

    def load(self, state) -> None:
        """Copy ``state``'s values into the chunk's buffers (a tensor that
        already is the chunk's, such as a KV cache prefilled in place, is
        left as it is). The next run continues from ``state``."""
        self._copy_in(_tensors(state))

    def _copy_in(self, tensors: dict[str, torch.Tensor]) -> None:
        own = _tensors(self.state)
        if own.keys() != tensors.keys():
            raise ValueError(f"a state of {sorted(tensors)} does not fit the chunk's {sorted(own)}")
        for k, src in tensors.items():
            dst = own[k]
            if dst is not src:
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    raise ValueError(f"{k}: {tuple(src.shape)} {src.dtype} does not fit the "
                                     f"chunk's {tuple(dst.shape)} {dst.dtype}")
                dst.copy_(src)

    def run(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The chunk's steps on ``.state``: one replay where it was
        captured, else one eager call of the body. Returns (tokens [B,
        n_steps], n_new [B]), the chunk's output buffers, which the next run
        overwrites."""
        global replays
        if self._graph is None:
            return self.run_eager()
        self._graph.replay()
        graphs.count_replay(self.launches_per_replay)
        replays += 1
        return self.out, self.n_new

    def run_eager(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The chunk's steps as one eager call of the body on the same
        buffers (a captured chunk's reference in the card's checks)."""
        global eager_steps
        self.body(self.state, self.out, self.n_new)
        if self.out.device.type == "cuda":
            eager_steps += self.n_steps
        return self.out, self.n_new
