"""Continuous-batching LLM worker (miotts_tpu/serving/batching.py).

A background worker owns a fixed set of lanes over one batched generation
state (``models/llm.py init_batched_state``). A request is tokenized at
``submit``, prefilled on the prefill thread, and attached to its lane by
the worker between chunks; every loop of the worker runs one chunk of
decode steps over ALL lanes, each lane with its own sampler settings, and
streams each lane's tokens back. New requests join at the next chunk
boundary; no request waits for another to finish.

On CUDA a chunk is one replay of a CUDA graph (``models/decode_graph.py``):
one graph for each chunk size of the ladder (``first_chunk``, ``chunk``,
``chunk_max``), all captured on the same state, with the per-lane sampler
tensors and the per-lane remaining budget ``rem`` as static buffers, so
one capture serves any mix of requests. JAX's run-time ``step_cap``
becomes a choice of graph: the smallest rung at or above the dispatch
size; ``rem`` marks a lane done the step its budget runs out, and the
delivery clamp keeps the delivered tokens JAX's. On the CPU the same
chunk body runs eagerly.

What the port runs of JAX's submit path is the unfused one
(``MIOTTS_FUSED_PREFILL=0`` there): the prefill thread coalesces queued
prompts into one ``llm_prefill_kv`` per prompt bucket (the group padded to
a power of two), on its own CUDA stream, and hands the worker an event to
wait on before it attaches. The worker dispatches, reads and delivers one
chunk at a time (JAX's ``MIOTTS_CHUNK_DEPTH`` is not ported), on a stream
of its own: no other thread's work (a codec decode, a prefill) is ordered
behind a chunk in flight.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import sys
import threading
import time

import numpy as np
import torch

from ..device import to_device
from ..models import decode_graph
from ..models.llm import (
    CHAT_TEMPLATE, LLMEngine, attach_lanes, capture_chunk_batched, fetch_chunk_result,
    init_batched_state, llm_generate_chunk_batched, llm_prefill_kv, set_lane_done,
)
from ..models.sampling import BatchSamplerParams, SamplerParams

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
        dev = self.device
        self.state = init_batched_state(self.cfg, n_lanes, max_ctx, dev, seed)
        # the chunk's per-lane inputs, static buffers of every chunk graph:
        # a lane's sampler settings are written at its attach, ``rem``
        # before each dispatch
        self.sampler = BatchSamplerParams.make(np.full(n_lanes, 0.8), np.full(n_lanes, 50),
                                               np.ones(n_lanes), np.ones(n_lanes), dev)
        self.rem = torch.zeros((n_lanes,), dtype=torch.int32, device=dev)
        # chunk graphs by size (CUDA), captured at first use or by
        # warm_chunks; only the worker (or a warm-up before any request)
        # captures or replays them
        self.use_graph = dev.type == "cuda"
        self.graphs: dict[int, decode_graph.ChunkGraph] = {}
        self._prefill_stream = torch.cuda.Stream(dev) if self.use_graph else None
        self._stream = torch.cuda.Stream(dev) if self.use_graph else None
        if self._stream is not None:  # the worker's stream follows the state's init
            self._stream.wait_stream(torch.cuda.current_stream(dev))
        self.lanes: list[_Lane | None] = [None] * n_lanes
        # attaches are queued and applied only by the worker, between
        # chunks: (host lane list, apply(state) -> state)
        self._pending: list[tuple[list[int], object]] = []
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
        """Dispatch one prompt-bucket group's prefill and return its finish
        closures, which queue the group's attach for the worker. The lane
        count is padded to a power of two; pad rows carry an out-of-range
        lane, so their attach writes drop."""
        kp = 1 << max(0, len(group) - 1).bit_length()
        toks = np.zeros((kp, bucket), np.int64)
        lens = np.ones(kp, np.int32)
        lanes = np.full(kp, self.n_lanes, np.int64)
        seeds = np.zeros(kp, np.int64)
        for i, (lane_idx, ids, T, _b, seed) in enumerate(group):
            toks[i, :T] = ids
            lens[i] = T
            lanes[i] = lane_idx
            seeds[i] = int(seed) & 0xFFFFFFFF
        try:
            if self._work_started is None:
                self._work_started = time.monotonic()
            prefill = self._prefill(toks, lens)
        except Exception as e:  # fail this group's requests; keep serving
            print(f"mio: batched prefill failed: {e!r}", file=sys.stderr)
            self._fail_unstarted([it[0] for it in group], e)
            return []

        def apply_fn(state):
            return self._attach(state, lanes, lens, seeds, *prefill)

        def finish_group() -> None:
            self._last_progress = time.monotonic()
            with self._cv:
                self._pending.append(([it[0] for it in group], apply_fn))
                self._cv.notify_all()

        return [finish_group]

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

    def warm_prefill(self, bucket: int, n_lanes: int = 1) -> None:
        """Run one prefill of this prompt bucket at ``n_lanes`` lanes (its
        first-use costs: kernel loads, cuBLAS plans), without a generation."""
        bucket = min(bucket, self.max_ctx)
        logits, _k, _v, event = self._prefill(np.ones((n_lanes, bucket), np.int64),
                                              np.full(n_lanes, min(4, bucket), np.int32))
        if event is not None:
            event.synchronize()

    def warm_chunks(self) -> None:
        """Capture the chunk graph of every size of the ladder (CUDA; before
        any request, so on a state whose lanes are all done)."""
        if self.use_graph:
            for size in self.ladder:
                self._graph(size)

    def _graph(self, size: int) -> decode_graph.ChunkGraph:
        graph = self.graphs.get(size)
        if graph is None:
            graph = self.graphs[size] = capture_chunk_batched(
                self.cfg, self.engine.weights, self.engine.eog_ids, size, self.sampler,
                self.rem, self.state)
        return graph

    def _rung(self, size: int) -> int:
        """The chunk size that runs a dispatch of ``size`` steps: the
        smallest rung of the ladder at or above it."""
        return next(r for r in self.ladder if r >= size)

    def _chunk(self, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
        """One chunk of ``steps`` steps on the state: a replay on CUDA, the
        eager body on the CPU."""
        if self.use_graph:
            return self._graph(steps).run()
        out, n_new, _ = llm_generate_chunk_batched(self.cfg, self.engine.weights,
                                                   self.engine.eog_ids, steps, self.sampler,
                                                   self.state, self.rem)
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
        with (torch.cuda.stream(self._stream) if self._stream is not None
              else contextlib.nullcontext()):
            self._loop()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._shutdown and not self._pending
                       and all(lane is None or not lane.started for lane in self.lanes)):
                    self._cv.wait()
                if self._shutdown:
                    return
                for lane_list, apply_fn in self._pending:
                    # a failed attach fails this group's requests only
                    try:
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
                self._pending.clear()
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
                size = self._dispatch_size(snapshot)
                rem_np = np.zeros(self.n_lanes, np.int32)
                for i, lane in snapshot:
                    rem_np[i] = max(0, lane.n_predict - lane.dispatched)
            if not snapshot:
                continue
            steps = self._rung(size)
            for _, lane in snapshot:
                lane.dispatched += size
            tf = time.monotonic()
            try:
                if self._work_started is None:
                    self._work_started = time.monotonic()
                self.rem.copy_(to_device(rem_np, self.device))
                out, n_new = self._chunk(steps)
                out_np, n_np, done_np = fetch_chunk_result(out, n_new, self.state)
            except Exception as e:  # device failure: fail the cohort, keep serving
                self._fail_active_lanes(sorted(i for i, _ in snapshot), e)
                continue
            dt_fetch = time.monotonic() - tf
            if dt_fetch > self.stall_event_s:
                self.stall_events += 1
            self.longest_fetch_s = max(self.longest_fetch_s, dt_fetch)
            self._deliver_chunk(out_np, n_np, done_np, snapshot)
            self._last_progress = time.monotonic()
            self._work_started = None

    def _dispatch_size(self, snapshot) -> int:
        """This dispatch's chunk size (miotts_tpu/serving/batching.py:869):
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
                    continue
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
