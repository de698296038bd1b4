"""Continuous-batching LLM worker (miotts_tpu/serving/batching.py).

A background worker owns a fixed set of lanes over one batched generation
state (``models/llm.py init_batched_state``). A request is tokenized at
``submit``, prefilled on the prefill thread, and attached to its lane by
the worker between chunks; every loop of the worker runs one chunk of
decode steps, each lane with its own sampler settings, and streams each
lane's tokens back. New requests join at the next chunk boundary; no
request waits for another to finish.

On CUDA a chunk is one replay of a CUDA graph (``models/decode_graph.py``),
all captured on the same state, with the per-lane sampler tensors, the
per-lane remaining budget ``rem`` and each width's lane list as static
buffers, so one capture serves any mix of requests. JAX's run-time
``step_cap`` becomes a choice of graph: the smallest rung of the ladder
(``first_chunk``, ``chunk``, ``chunk_max``) at or above the dispatch
size; ``rem`` marks a lane done the step its budget runs out, and the
delivery clamp keeps the delivered tokens JAX's. On the CPU the same
bodies run eagerly. The JAX batcher's knobs, with its names and defaults:

- width-sliced chunks (``MIOTTS_CHUNK_SLICE``, default on): below full
  occupancy a chunk gathers the live lanes into the smallest power-of-two
  width that covers them, runs only those and scatters them back
  (``llm_generate_chunk_batched_sliced``), so a lone request pays for one
  lane, not all of them. The port keeps one graph per (rung, width)
  (``graphs``, ``_warm_chunks``) where JAX keeps one executable per width.
  Pad rows of a sliced chunk are distinct lanes outside the live set
  (``models/llm.py _chunk_body_sliced``).
- the fused prefill (``MIOTTS_FUSED_PREFILL``, default on): the prefill
  thread runs a group's prefill (eager, on its own stream) and its first
  ``first_chunk`` steps, then delivers those tokens at once; the worker
  attaches the lanes mid-generation (``attach_lanes_gen``). On CUDA the
  first chunk replays one graph per power-of-two group size k on a k-lane
  state of ``max_ctx`` cache rows, which serves every prompt bucket.
  ``MIOTTS_FUSED_PREFILL=0`` is the unfused path: ``llm_prefill_kv``,
  an attach, and a first chunk in the cohort.
- the attach hold (``MIOTTS_ATTACH_HOLD_S``, default 1.0 s): while a
  strict majority of reserved lanes is still being prefilled, the worker
  waits (in steps of at most 50 ms) for their attach instead of running a
  chunk for the few attached lanes.
- the chunk-ahead fetch (``MIOTTS_CHUNK_DEPTH``, default 1): up to depth
  chunks are dispatched before the oldest one's result is read. Each
  chunk's result is packed and copied to pinned host memory, with an
  event, on the worker's stream before the next replay is queued
  (``models/llm.py ChunkFetch``); a snapshot of lane objects keeps a
  chunk's tokens from reaching a lane freed and attached again while it
  was in flight.
- the warm registries behind ``ServingEngine.warmup``'s background tail:
  ``_warm_prefills`` ((bucket, k) groups run) with
  ``split_cold_until_warm`` (a burst that needs a group size not yet warm
  splits into the largest warm one), and ``_warm_chunks`` with
  ``_pick_width``.

The worker runs on a CUDA stream of its own: no other thread's work (a
codec decode, a prefill) is ordered behind a chunk in flight. A width
graph captured while the worker replays runs its warm-up on a throwaway
state (``_warm_state``), since a capture executes nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from ..device import to_device
from ..models import decode_graph
from ..models.llm import (
    CHAT_TEMPLATE, NO_BUDGET, GenState, LLMEngine, attach_lanes, attach_lanes_gen,
    capture_chunk_batched, capture_chunk_batched_sliced, finish_chunk_fetch, fused_state,
    init_batched_state, llm_generate_chunk_batched, llm_generate_chunk_batched_sliced,
    llm_prefill_generate, llm_prefill_kv, prefill_into, set_lane_done, start_chunk_fetch,
)
from ..models.sampling import BatchSamplerParams, SamplerParams
from ..runtime.tracing import trace_phase

_PROMPT_BUCKETS = (32, 64, 128, 256, 512)


@dataclasses.dataclass
class _Lane:
    handle: "GenerationHandle"
    n_predict: int
    generated: int = 0
    started: bool = False  # attach applied to the device state
    dispatched: int = 0  # decode steps dispatched
    # whether the consumer reads tokens as they come (SSE token stream,
    # stream_audio, overlap synthesis): only such lanes pull the cohort's
    # dispatch down to first_chunk
    early: bool = True
    # written into the chunk graphs' sampler buffers at the lane's attach
    sampler: SamplerParams = dataclasses.field(default_factory=SamplerParams)


class GenerationHandle:
    """Per-request stream of generated tokens."""

    def __init__(self):
        self._q: "queue.Queue[list[int] | None]" = queue.Queue()
        self.cancelled = threading.Event()
        self.error: Exception | None = None

    def cancel(self) -> None:
        self.cancelled.set()

    def tokens(self):
        """Yield tokens until generation completes. Raises the worker's
        exception if the request's lane failed."""
        while True:
            batch = self._q.get()
            if batch is None:
                if self.error is not None:
                    raise self.error
                return
            yield from batch

    def collect(self) -> list[int]:
        return list(self.tokens())


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


class ContinuousBatcher:
    def __init__(self, engine: LLMEngine, n_lanes: int = 8, max_ctx: int = 1024,
                 chunk: int = 16, seed: int = 0, first_chunk: int | None = None):
        self.engine = engine
        self.cfg = engine.config
        self.device = engine.device
        # the dispatch ladder (miotts_tpu/serving/batching.py:101-127): a
        # fresh lane's first chunk is small (its first tokens early), a
        # lane that has run a steady chunk graduates to chunk_max
        chunk = int(os.environ.get("MIOTTS_CHUNK_STEPS", chunk))
        if first_chunk is None:
            first_chunk = int(os.environ.get("MIOTTS_FIRST_CHUNK", "12"))
        self.first_chunk = max(1, min(first_chunk or chunk, chunk))
        self.chunk_max = max(chunk, int(os.environ.get("MIOTTS_CHUNK_MAX", str(2 * chunk))))
        self.ladder = tuple(sorted({self.first_chunk, chunk, self.chunk_max}))
        self.n_lanes = n_lanes
        self.max_ctx = max_ctx
        self.chunk = chunk
        self.seed = seed
        self.fused_prefill = os.environ.get("MIOTTS_FUSED_PREFILL", "1") != "0"
        self.slice_chunks = n_lanes > 1 and os.environ.get("MIOTTS_CHUNK_SLICE", "1") != "0"
        self.attach_hold_s = float(os.environ.get("MIOTTS_ATTACH_HOLD_S", "1.0"))
        self.depth = max(1, int(os.environ.get("MIOTTS_CHUNK_DEPTH", "1")))
        self._attach_hold_t0: float | None = None
        # how often, and for how long, the worker held a dispatch for a
        # burst's attaches (read by chip_smoke.py and the trace script)
        self.attach_holds = 0
        self.attach_hold_ms = 0.0
        # chunks dispatched at each width (n_lanes: full width)
        self.width_counts: dict[int, int] = {}
        dev = self.device
        self.state = init_batched_state(self.cfg, n_lanes, max_ctx, dev, seed)
        # the chunk's per-lane inputs, static buffers of every chunk graph:
        # a lane's sampler settings are written at its attach, ``rem``
        # before each dispatch, a width's lane list before its replay
        self.sampler = BatchSamplerParams.make(np.full(n_lanes, 0.8), np.full(n_lanes, 50),
                                               np.ones(n_lanes), np.ones(n_lanes), dev)
        self.rem = torch.zeros((n_lanes,), dtype=torch.int32, device=dev)
        self._lanes_bufs = {1 << i: torch.zeros((1 << i,), dtype=torch.int64, device=dev)
                            for i in range(max(0, n_lanes - 1).bit_length())}
        # chunk graphs by (rung, width) on CUDA, captured at first use or by
        # warm_chunk; replaced whole under _capture_lock, read lock-free
        self.use_graph = dev.type == "cuda"
        self.graphs: dict[tuple[int, int], decode_graph.ChunkGraph] = {}
        self._capture_lock = threading.Lock()
        # fused first-chunk graphs by group size k: (graph, its sampler)
        self._fused: dict[int, tuple] = {}
        self._fused_lock = threading.Lock()
        # (bucket, k) prefill groups and (rung, width) chunks known warm;
        # frozensets replaced under _warm_lock, read lock-free
        self._warm_prefills: frozenset[tuple[int, int]] = frozenset()
        self._warm_chunks: frozenset[tuple[int, int]] = frozenset()
        self._warm_lock = threading.Lock()
        self.split_cold_until_warm = False
        self._warm_state: GenState | None = None
        self._prefill_stream = torch.cuda.Stream(dev) if self.use_graph else None
        self._stream = torch.cuda.Stream(dev) if self.use_graph else None
        if self._stream is not None:  # the worker's stream follows the state's init
            self._stream.wait_stream(torch.cuda.current_stream(dev))
        self.lanes: list[_Lane | None] = [None] * n_lanes
        # attaches are queued and applied only by the worker, between
        # chunks: (host lane list, apply(state) -> state, finish list of
        # (lane, needs set_lane_done) already delivered in the fused steps)
        self._pending: list[tuple[list[int], object, list]] = []
        self._prefill_q: "queue.Queue[tuple | None]" = queue.Queue()
        self._prefill_thread = threading.Thread(target=self._prefill_loop, daemon=True,
                                                name="batcher-prefill")
        self._prefill_thread.start()
        # device-stall watchdog: set when a chunk is dispatched, refreshed
        # on every delivery (surfaced by /mio/health)
        self._work_started: float | None = None
        self._last_progress = time.monotonic()
        self.stall_threshold_s = float(os.environ.get("MIOTTS_DEVICE_STALL_S", "120"))
        # chunk reads slower than this count toward stall_events (/metrics)
        self.stall_event_s = float(os.environ.get("MIOTTS_STALL_EVENT_S", "5"))
        self.stall_events = 0
        self.longest_fetch_s = 0.0
        self._cv = threading.Condition()
        self._shutdown = False
        self._thread = threading.Thread(target=self._run, daemon=True, name="batcher-worker")
        self._thread.start()

    def widths(self) -> list[int]:
        """The chunk widths: 1, 2, 4, ... below the lane count, then the
        full width (only the full width without slicing)."""
        out = []
        w = 1
        while self.slice_chunks and w < self.n_lanes:
            out.append(w)
            w *= 2
        return out + [self.n_lanes]

    # -- submission -------------------------------------------------------------

    def submit(self, text: str, sampler: SamplerParams | None = None,
               n_predict: int = 400, timeout: float | None = None,
               early_tokens: bool = True) -> GenerationHandle:
        sampler = sampler or SamplerParams()
        ids = self.engine.tokenizer.encode(CHAT_TEMPLATE.format(text=text), parse_special=True)
        T = len(ids)
        if T > self.max_ctx - 8:
            raise ValueError(
                f"prompt is too long for the configured context "
                f"({T} tokens > {self.max_ctx - 8}); raise --ctx-size")
        bucket = next((b for b in _PROMPT_BUCKETS if T <= b), ((T + 127) // 128) * 128)
        bucket = min(bucket, self.max_ctx)
        n_predict = min(n_predict, self.max_ctx - T - 1)

        handle = GenerationHandle()
        with self._cv:
            while (lane_idx := self._free_lane()) is None:
                if not self._cv.wait(timeout=timeout):
                    raise TimeoutError("no free generation lane")
            self.lanes[lane_idx] = _Lane(handle=handle, n_predict=n_predict, early=early_tokens,
                                         sampler=sampler)
        self._prefill_q.put((lane_idx, ids, T, bucket, sampler.seed))
        return handle

    # -- batched prefill --------------------------------------------------------

    def _prefill_loop(self) -> None:
        """Drain-style coalescing: the first queued prompt is taken
        blocking, then whatever else is already waiting joins it, one
        prefill per prompt bucket. Every group is dispatched before any is
        finished; a group whose dispatch or finish fails fails only its
        own requests, and the thread keeps draining."""
        while True:
            item = self._prefill_q.get()
            if item is None:
                return
            items = [item]
            while True:
                try:
                    nxt = self._prefill_q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._prefill_q.put(None)  # re-post shutdown
                    break
                items.append(nxt)
            groups: dict[int, list[tuple]] = {}
            for it in items:
                groups.setdefault(it[3], []).append(it)
            finishes: list = []
            for bucket in sorted(groups):
                lane_idxs = [it[0] for it in groups[bucket]]
                try:
                    finishes.extend((lane_idxs, fin)
                                    for fin in self._prefill_group(bucket, groups[bucket]))
                except Exception as e:
                    print(f"mio: prefill group failed: {e!r}", file=sys.stderr)
                    self._fail_unstarted(lane_idxs, e)
            for lane_idxs, fin in finishes:
                # the reference's finish loop is unguarded: one failing
                # delivery killed the thread and leaked every reserved lane
                try:
                    fin()
                except Exception as e:
                    print(f"mio: prefill finish failed: {e!r}", file=sys.stderr)
                    self._fail_unstarted(lane_idxs, e)

    def _prefill_group(self, bucket: int, group: list[tuple]) -> list:
        """Dispatch one prompt-bucket group's prefill (fused with its first
        steps, or not) and return its finish closures, which deliver the
        fused tokens and queue the group's attach for the worker. The lane
        count is padded to a power of two; pad rows carry an out-of-range
        lane, so their attach writes drop. While the warm-up tail runs
        (``split_cold_until_warm``), a group size not yet warm splits into
        the largest warm one."""
        kp = _pow2(len(group))
        if kp > 1 and self.split_cold_until_warm and (bucket, kp) not in self._warm_prefills:
            warmed = [n for (b, n) in self._warm_prefills if b == bucket and n < kp]
            if warmed:
                sub = max(warmed)
                conts: list = []
                for i in range(0, len(group), sub):
                    conts.extend(self._prefill_group(bucket, group[i:i + sub]))
                return conts
        toks = np.zeros((kp, bucket), np.int64)
        lens = np.ones(kp, np.int32)
        lanes = np.full(kp, self.n_lanes, np.int64)
        seeds = np.zeros(kp, np.int64)
        for i, (lane_idx, ids, T, _b, seed) in enumerate(group):
            toks[i, :T] = ids
            lens[i] = T
            lanes[i] = lane_idx
            seeds[i] = int(seed) & 0xFFFFFFFF
        fused = self._use_fused(bucket)
        try:
            if self._work_started is None:
                self._work_started = time.monotonic()
            with trace_phase(f"prefill_group bucket={bucket} k={kp} fused={int(fused)}"):
                if fused:
                    fetch, gst, event = self._prefill_fused(toks, lens, seeds,
                                                            self._group_sampler(kp, group))

                    def apply_fn(state):
                        return self._attach_gen(state, lanes, gst, event)
                else:
                    prefill = self._prefill(toks, lens)

                    def apply_fn(state):
                        return self._attach(state, lanes, lens, seeds, *prefill)
        except Exception as e:  # fail this group's requests; keep serving
            print(f"mio: batched prefill failed: {e!r}", file=sys.stderr)
            self._fail_unstarted([it[0] for it in group], e)
            return []

        def finish_group() -> None:
            out_np = n_np = done_np = None
            if fused:
                out_np, n_np, done_np = finish_chunk_fetch(fetch)
            self._last_progress = time.monotonic()
            with self._warm_lock:
                self._warm_prefills = self._warm_prefills | {(bucket, kp)}
            finish: list[tuple[int, bool]] = []
            with self._cv:
                if fused:
                    # the fused first tokens go out now, one prefill after
                    # submit, whatever the cohort's chunk boundaries
                    for i, (lane_idx, *_rest) in enumerate(group):
                        lane = self.lanes[lane_idx]
                        if lane is None:
                            continue
                        n = min(int(n_np[i]), lane.n_predict)
                        toks_out = [int(t) for t in out_np[i, :n]]
                        lane.generated = len(toks_out)
                        lane.dispatched = self.first_chunk
                        if toks_out and not lane.handle.cancelled.is_set():
                            lane.handle._q.put(toks_out)
                        if (bool(done_np[i]) or lane.generated >= lane.n_predict
                                or lane.handle.cancelled.is_set()):
                            # finished inside the fused steps: the worker
                            # frees the lane right after the attach applies
                            finish.append((lane_idx, not bool(done_np[i])))
                self._pending.append(([it[0] for it in group], apply_fn, finish))
                self._cv.notify_all()

        return [finish_group]

    def _use_fused(self, bucket: int) -> bool:
        # the mini state's rows [0, bucket + first_chunk) scatter into
        # [*, max_ctx]: no fusing when the prompt bucket leaves no room
        return self.fused_prefill and bucket + self.first_chunk <= self.max_ctx

    def _group_sampler(self, kp: int, group: list[tuple]) -> list[SamplerParams]:
        """The sampler settings of a group's kp rows (pad rows: defaults)."""
        params = [SamplerParams()] * kp
        for i, (lane_idx, *_rest) in enumerate(group):
            lane = self.lanes[lane_idx]
            if lane is not None:
                params[i] = lane.sampler
        return params

    def _prefill(self, toks: np.ndarray, lens: np.ndarray):
        """``llm_prefill_kv`` of padded prompts, on the prefill stream on
        CUDA: (logits, K, V, the event the worker waits on or None)."""
        dev = self.device
        if self._prefill_stream is None:
            return (*llm_prefill_kv(self.cfg, self.engine.weights, to_device(toks, dev),
                                    to_device(lens, dev)), None)
        with torch.cuda.stream(self._prefill_stream):
            out = llm_prefill_kv(self.cfg, self.engine.weights, to_device(toks, dev),
                                 to_device(lens, dev))
            event = torch.cuda.Event()
            event.record(self._prefill_stream)
        return (*out, event)

    def _prefill_fused(self, toks: np.ndarray, lens: np.ndarray, seeds: np.ndarray,
                       params: list[SamplerParams]):
        """The prefill and first ``first_chunk`` steps of a group of k rows:
        (the tokens' ``ChunkFetch``, the mini state for ``attach_lanes_gen``,
        the event the worker waits on or None). Under ``use_graph`` the
        steps replay the graph of k lanes on its state of ``max_ctx`` rows,
        and the mini state handed on is a copy of its first bucket +
        first_chunk rows (the next group may reuse the graph before the
        worker attaches); the eager path is ``llm_prefill_generate``."""
        dev = self.device
        k = toks.shape[0]
        sampler_np = [[p.temp for p in params], [p.top_k for p in params],
                      [p.top_p for p in params], [p.repeat_penalty for p in params]]
        if not self.use_graph:
            out, n_new, gst = llm_prefill_generate(
                self.cfg, self.engine.weights, self.engine.eog_ids, self.first_chunk,
                to_device(toks, dev), to_device(lens, dev), seeds,
                BatchSamplerParams.make(*sampler_np, dev))
            return start_chunk_fetch(out, n_new, gst), gst, None
        with self._fused_lock, _on(self._prefill_stream):
            graph, sampler = self._fused_graph(k)
            sampler.copy_(BatchSamplerParams.make(*sampler_np, dev))
            st = prefill_into(self.cfg, self.engine.weights, to_device(toks, dev),
                              to_device(lens, dev), seeds, graph.state)
            out, n_new = graph.run()
            fetch = start_chunk_fetch(out, n_new, st)
            T = min(toks.shape[1] + self.first_chunk, self.max_ctx)
            gst = GenState(st.logits.clone(), st.cache_k[:, :, :T].clone(),
                           st.cache_v[:, :, :T].clone(), st.pos.clone(), st.ring.clone(),
                           st.ring_idx, st.done.clone(), st.key.clone())
            event = None
            if self._prefill_stream is not None:
                event = torch.cuda.Event()
                event.record(self._prefill_stream)
        return fetch, gst, event

    def _fused_graph(self, k: int):
        """The fused first chunk's graph for k lanes and its sampler
        buffers, captured at first use (the caller holds _fused_lock); the
        graph keeps its unbudgeted ``rem`` through its body."""
        entry = self._fused.get(k)
        if entry is None:
            dev = self.device
            sampler = BatchSamplerParams.make(np.full(k, 0.8), np.full(k, 50), np.ones(k),
                                              np.ones(k), dev)
            rem = torch.full((k,), NO_BUDGET, dtype=torch.int32, device=dev)
            graph = capture_chunk_batched(self.cfg, self.engine.weights, self.engine.eog_ids,
                                          self.first_chunk, sampler, rem,
                                          fused_state(self.cfg, k, self.max_ctx, dev))
            entry = self._fused[k] = (graph, sampler)
        return entry

    @staticmethod
    def _attach(state, lanes, lens, seeds, logits, new_k, new_v, event):
        """The worker's attach of a prefilled group: on CUDA its stream
        first waits for the prefill, and the prefill's tensors are marked as
        used there, so the prefill stream cannot reuse their memory before
        the copies ran."""
        if event is not None:
            stream = torch.cuda.current_stream(logits.device)
            stream.wait_event(event)
            for t in (logits, new_k, new_v):
                t.record_stream(stream)
        return attach_lanes(state, lanes, logits, new_k, new_v, lens, seeds)

    @staticmethod
    def _attach_gen(state, lanes, gst: GenState, event):
        """The worker's attach of a fused group (``attach_lanes_gen``), after
        the prefill stream's event, as ``_attach``."""
        if event is not None:
            stream = torch.cuda.current_stream(gst.logits.device)
            stream.wait_event(event)
            for t in (gst.logits, gst.cache_k, gst.cache_v, gst.pos, gst.ring, gst.done, gst.key):
                t.record_stream(stream)
        return attach_lanes_gen(state, lanes, gst)

    @property
    def device_stalled(self) -> bool:
        """True when device work has been in flight with no completed chunk
        for stall_threshold_s (MIOTTS_DEVICE_STALL_S, default 120 s).
        Monitoring only; surfaced via /mio/health."""
        started = self._work_started
        if started is None:
            return False
        ref = max(started, self._last_progress)
        return time.monotonic() - ref > self.stall_threshold_s

    def _fail_unstarted(self, lane_idxs: list[int], exc: Exception) -> None:
        """Deliver a prefill/attach failure to not-yet-started lanes and
        free them (started lanes belong to the chunk loop's failure path)."""
        self._work_started = None
        with self._cv:
            for lane_idx in lane_idxs:
                lane = self.lanes[lane_idx]
                if lane is not None and not lane.started:
                    lane.handle.error = exc
                    lane.handle._q.put(None)
                    self.lanes[lane_idx] = None
            self._cv.notify_all()

    # -- warm-up ------------------------------------------------------------------

    def warm_prefill(self, bucket: int, n_lanes: int = 1) -> None:
        """Run one prefill group of this prompt bucket at ``n_lanes`` lanes,
        without a request: the fused prefill and first chunk when that is
        what submits dispatch (capturing the first chunk's graph for this
        group size at its first use), else ``llm_prefill_kv``; then
        registers (bucket, n_lanes) as warm."""
        bucket = min(bucket, self.max_ctx)
        toks = np.ones((n_lanes, bucket), np.int64)
        lens = np.full(n_lanes, min(4, bucket), np.int32)
        if self._use_fused(bucket):
            fetch, _gst, _event = self._prefill_fused(toks, lens, np.zeros(n_lanes, np.int64),
                                                      [SamplerParams()] * n_lanes)
            finish_chunk_fetch(fetch)
        else:
            event = self._prefill(toks, lens)[3]
            if event is not None:
                event.synchronize()
        with self._warm_lock:
            self._warm_prefills = self._warm_prefills | {(bucket, n_lanes)}

    def _pick_width(self, size: int, need: int) -> int | None:
        """The chunk width for ``need`` live lanes at rung ``size``, or None
        for the full width (miotts_tpu/serving/batching.py:522-550): the
        smallest power of two covering them; if that one is not warm but a
        wider one is, the wider one runs (a warm 2x-width graph beats a
        capture stalling the cohort). A width is captured on demand only
        when nothing warm covers it, and never while the warm-up tail still
        runs (``split_cold_until_warm``): the full width, warmed in the
        foreground, runs meanwhile."""
        if not self.slice_chunks or need <= 0:
            return None
        w = _pow2(need)
        if w >= self.n_lanes:
            return None
        warmed = self._warm_chunks  # immutable snapshot
        if (size, w) in warmed:
            return w
        covering = [wd for (s, wd) in warmed if s == size and w < wd < self.n_lanes]
        if covering:
            return min(covering)
        if (size, self.n_lanes) in warmed or self.split_cold_until_warm:
            return None
        return w

    def warm_chunk(self, size: int | None = None, width: int | None = None) -> None:
        """Make the chunk of ``size`` steps (default ``chunk_max``) at
        ``width`` lanes (None or >= n_lanes: the full width) warm without
        touching live generation: on CUDA its graph is captured with the
        warm-up run on the throwaway ``_warm_state``, so this may run while
        the worker serves (miotts_tpu/serving/batching.py:552-593). On the
        CPU there is nothing to compile: the key is registered. Thread-safe."""
        size = self.chunk_max if size is None else size
        width = self.n_lanes if width is None or width >= self.n_lanes else width
        if self.use_graph:
            self._graph(size, width)
        else:
            self._warm_state_now()
        with self._warm_lock:
            self._warm_chunks = self._warm_chunks | {(size, width)}

    def release_warm_state(self) -> None:
        """Drop the throwaway warm state (a full KV cache) once the warm-up
        tail no longer captures; a later capture makes a new one."""
        with self._capture_lock:
            self._warm_state = None

    def _warm_state_now(self) -> GenState:
        """The throwaway state of the live state's shapes (all lanes done)
        that captures run their warm-up on; the caller holds
        _capture_lock or tolerates a race that makes two."""
        ws = self._warm_state
        if ws is None:
            ws = self._warm_state = init_batched_state(self.cfg, self.n_lanes, self.max_ctx,
                                                       self.device, self.seed)
        return ws

    def _graph(self, size: int, width: int) -> decode_graph.ChunkGraph:
        """The chunk graph of (size, width), captured at first use on the
        live state, its warm-up run on ``_warm_state``."""
        graph = self.graphs.get((size, width))
        if graph is not None:
            return graph
        with self._capture_lock:
            graph = self.graphs.get((size, width))
            if graph is None:
                ws = self._warm_state_now()
                args = (self.cfg, self.engine.weights, self.engine.eog_ids, size, self.sampler,
                        self.rem)
                if width >= self.n_lanes:
                    graph = capture_chunk_batched(*args, self.state, warm_state=ws)
                else:
                    graph = capture_chunk_batched_sliced(*args, self._lanes_bufs[width],
                                                         self.state, warm_state=ws)
                self.graphs = {**self.graphs, (size, width): graph}
        return graph

    def _rung(self, size: int) -> int:
        """The chunk size that runs a dispatch of ``size`` steps: the
        smallest rung of the ladder at or above it."""
        return next(r for r in self.ladder if r >= size)

    def _chunk(self, steps: int, width: int | None, lanes_np: np.ndarray | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """One chunk of ``steps`` steps on the state at ``width`` lanes
        (None: all): a replay on CUDA, the eager body on the CPU."""
        if width is None:
            if self.use_graph:
                return self._graph(steps, self.n_lanes).run()
            out, n_new, _ = llm_generate_chunk_batched(self.cfg, self.engine.weights,
                                                       self.engine.eog_ids, steps, self.sampler,
                                                       self.state, self.rem)
            return out, n_new
        lanes = self._lanes_bufs[width]
        lanes.copy_(to_device(lanes_np, self.device))
        if self.use_graph:
            return self._graph(steps, width).run()
        out, n_new, _ = llm_generate_chunk_batched_sliced(
            self.cfg, self.engine.weights, self.engine.eog_ids, steps, width, self.sampler,
            self.state, lanes, self.rem)
        return out, n_new

    def _free_lane(self) -> int | None:
        for i, lane in enumerate(self.lanes):
            if lane is None:
                return i
        return None

    def shutdown(self) -> None:
        self._prefill_q.put(None)
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        self._thread.join(timeout=5)
        self._prefill_thread.join(timeout=5)

    def _fail_active_lanes(self, snapshot: list[int], exc: Exception) -> None:
        """Deliver a device failure to every in-flight request and reset
        the batched state (in place: the chunk graphs own its buffers) so
        later submits start clean."""
        print(f"mio: generation chunk failed, resetting lanes: {exc!r}", file=sys.stderr)
        self._work_started = None
        with self._cv:
            for i in snapshot:
                lane = self.lanes[i]
                if lane is None:
                    continue
                lane.handle.error = exc
                lane.handle._q.put(None)
                self.lanes[i] = None
            try:
                self.state.done.fill_(True)
                self.state.ring.fill_(-1)
            except Exception as e:  # a card in a sticky error state
                print(f"mio: lane reset failed: {e!r}", file=sys.stderr)
            self._cv.notify_all()

    # -- worker loop ---------------------------------------------------------------

    def _run(self) -> None:
        # every device call of the worker (attach, chunk, read, lane done)
        # runs on its own stream
        with _on(self._stream):
            self._loop()

    def _apply_pending(self) -> None:
        """Apply the queued attaches (the caller holds _cv): a failed one
        fails its group only; lanes that finished inside their fused steps
        are freed right after their attach."""
        for lane_list, apply_fn, finish in self._pending:
            try:
                with trace_phase(f"attach k={len(lane_list)}"):
                    self.state = apply_fn(self.state)
            except Exception as e:
                print(f"mio: lane attach failed: {e!r}", file=sys.stderr)
                for lane_idx in lane_list:
                    lane = self.lanes[lane_idx]
                    if lane is not None and not lane.started:
                        lane.handle.error = e
                        lane.handle._q.put(None)
                        self.lanes[lane_idx] = None
                self._cv.notify_all()
                continue
            for lane_idx in lane_list:
                lane = self.lanes[lane_idx]
                if lane is not None:
                    lane.started = True
                    self.sampler.set_lane(lane_idx, lane.sampler)
            for lane_idx, needs_done in finish:
                lane = self.lanes[lane_idx]
                if lane is None:
                    continue
                lane.handle._q.put(None)
                self.lanes[lane_idx] = None
                if needs_done:
                    set_lane_done(self.state, lane_idx)
                self._cv.notify_all()
        self._pending.clear()

    def _loop(self) -> None:
        inflight: deque = deque()  # (ChunkFetch, snapshot, size)
        while True:
            with self._cv:
                while (not inflight and not self._shutdown and not self._pending
                       and all(lane is None or not lane.started for lane in self.lanes)):
                    self._cv.wait()
                if self._shutdown:
                    return
                self._apply_pending()
                # a lane with no budget left owes nothing: free it here, or
                # the loop would spin on it
                for i, lane in enumerate(self.lanes):
                    if lane is not None and lane.started and lane.generated >= lane.n_predict:
                        lane.handle._q.put(None)
                        self.lanes[i] = None
                        set_lane_done(self.state, i)
                        self._cv.notify_all()
                # the snapshot carries the lane objects: delivery checks that
                # self.lanes[i] is still the same request
                snapshot = [(i, lane) for i, lane in enumerate(self.lanes)
                            if lane is not None and lane.started]
                # steps in flight per lane object (a lane index may have been
                # attached again; the new request owes nothing for them)
                steps_inflight: dict[int, int] = {}
                for _fetch, snap, size_k in inflight:
                    for _i, lobj in snap:
                        steps_inflight[id(lobj)] = steps_inflight.get(id(lobj), 0) + size_k
                worth_dispatching = any(
                    lane.generated + steps_inflight.get(id(lane), 0) < lane.n_predict
                    for _i, lane in snapshot)
                # the attach hold: a strict majority of reserved lanes still
                # being prefilled defers the dispatch, at most attach_hold_s
                n_unstarted = sum(1 for lane in self.lanes if lane is not None and not lane.started)
                held = False
                if snapshot and n_unstarted > len(snapshot):
                    now = time.monotonic()
                    if self._attach_hold_t0 is None:
                        self._attach_hold_t0 = now
                        self.attach_holds += 1
                    held = now - self._attach_hold_t0 < self.attach_hold_s
                else:
                    self._attach_hold_t0 = None
                size = self._dispatch_size(snapshot)
                rem_np = np.zeros(self.n_lanes, np.int32)
                for i, lane in snapshot:
                    rem_np[i] = max(0, lane.n_predict - lane.dispatched)
            if held and not inflight:
                hold_left = self.attach_hold_s - (time.monotonic() - (self._attach_hold_t0 or 0))
                th = time.monotonic()
                with self._cv:
                    if not self._pending and not self._shutdown:
                        self._cv.wait(timeout=max(0.001, min(0.05, hold_left)))
                self.attach_hold_ms += (time.monotonic() - th) * 1e3
                continue
            dispatched = False
            if snapshot and worth_dispatching and not held:
                steps = self._rung(size)
                width = self._pick_width(steps, len(snapshot))
                lanes_np = None
                if width is not None:
                    live = {i for i, _ in snapshot}
                    pads = [self.n_lanes + i for i in range(self.n_lanes) if i not in live]
                    lanes_np = np.array([i for i, _ in snapshot] + pads[:width - len(snapshot)],
                                        np.int64)
                for _, lane in snapshot:
                    lane.dispatched += size
                try:
                    if self._work_started is None:
                        self._work_started = time.monotonic()
                    with trace_phase(f"chunk_dispatch steps={steps} "
                                     f"width={width or self.n_lanes} live={len(snapshot)}"):
                        self.rem.copy_(to_device(rem_np, self.device))
                        out, n_new = self._chunk(steps, width, lanes_np)
                        fetch = start_chunk_fetch(out, n_new, self.state)
                    key = (steps, width or self.n_lanes)
                    if key not in self._warm_chunks:
                        with self._warm_lock:
                            self._warm_chunks = self._warm_chunks | {key}
                    self.width_counts[key[1]] = self.width_counts.get(key[1], 0) + 1
                    inflight.append((fetch, snapshot, size))
                    dispatched = True
                except Exception as e:  # device failure: fail the cohort, keep serving
                    self._fail_active_lanes(sorted({i for i, _ in snapshot} | {
                        i for chk in inflight for i, _ in chk[1]}), e)
                    inflight.clear()
                    continue
            # read the oldest chunk once the pipeline is full, or when
            # nothing new was dispatched (nothing left to overlap it with)
            if inflight and (len(inflight) > self.depth or not dispatched):
                fetch_k, snap_k, _size_k = inflight.popleft()
                tf = time.monotonic()
                try:
                    with trace_phase("chunk_fetch"):
                        out_np, n_np, done_np = finish_chunk_fetch(fetch_k)
                except Exception as e:  # device failure: fail the cohort, keep serving
                    self._fail_active_lanes(sorted({i for i, _ in snap_k} | {
                        i for chk in inflight for i, _ in chk[1]}), e)
                    inflight.clear()
                    continue
                dt_fetch = time.monotonic() - tf
                if dt_fetch > self.stall_event_s:
                    self.stall_events += 1
                self.longest_fetch_s = max(self.longest_fetch_s, dt_fetch)
                with trace_phase("chunk_deliver"):
                    self._deliver_chunk(out_np, n_np, done_np, snap_k)
                self._last_progress = time.monotonic()
                if not inflight:
                    self._work_started = None

    def _dispatch_size(self, snapshot) -> int:
        """This dispatch's chunk size (miotts_tpu/serving/batching.py:620):
        a fresh lane that reads tokens as they come pulls it down to
        ``first_chunk``, a lane that has run a steady chunk graduates to
        ``chunk_max``, and it shrinks to the largest remaining budget. A
        lone, uncontended lane skips the middle rung (MIOTTS_SOLO_FAST)."""
        uncontended = (len(snapshot) <= 1
                       and sum(1 for lane in self.lanes if lane is not None) <= len(snapshot)
                       and os.environ.get("MIOTTS_SOLO_FAST", "1") != "0")
        sizes = []
        remaining_max = 0
        for _, lane in snapshot:
            rem = lane.n_predict - lane.dispatched
            if rem <= 0:
                continue
            remaining_max = max(remaining_max, rem)
            if not lane.early:
                sizes.append(self.chunk_max)
            elif lane.dispatched == 0:
                sizes.append(self.first_chunk)
            elif lane.dispatched < self.first_chunk + self.chunk and not uncontended:
                sizes.append(self.chunk)
            else:
                sizes.append(self.chunk_max)
        size = min(sizes) if sizes else self.chunk
        if 0 < remaining_max < size:
            return remaining_max
        return size

    def _deliver_chunk(self, out_np, n_np, done_np, snapshot) -> None:
        with self._cv:
            freed = False
            for i, lane_at_dispatch in snapshot:
                lane = self.lanes[i]
                if lane is None or lane is not lane_at_dispatch:
                    continue  # freed (and possibly attached again) since dispatch
                toks = [int(t) for t in out_np[i, :int(n_np[i])]]
                budget_left = lane.n_predict - lane.generated
                if len(toks) > budget_left:
                    toks = toks[:budget_left]
                lane.generated += len(toks)
                if toks and not lane.handle.cancelled.is_set():
                    lane.handle._q.put(toks)
                if (bool(done_np[i]) or lane.generated >= lane.n_predict
                        or lane.handle.cancelled.is_set()):
                    lane.handle._q.put(None)
                    self.lanes[i] = None
                    if not done_np[i]:
                        set_lane_done(self.state, i)
                    freed = True
            if freed:
                self._cv.notify_all()
