"""Continuous-batching LLM worker (miotts_tpu/serving/batching.py).

A background worker owns a fixed set of lanes over one batched generation
state (``models/llm.py init_batched_state``). A request is tokenized at
``submit``, prefilled on the prefill thread, and attached to its lane by
the worker between chunks; every loop of the worker runs one chunk of
decode steps, each lane with its own sampler settings, and streams each
lane's tokens back. New requests join at the next chunk boundary; no
request waits for another to finish.

A chunk is the ``run()`` of one ``llm.chunk`` (``models/decode_graph.py``:
a replay of a CUDA graph on the card, the eager body elsewhere), all made
on the same state, with the per-lane sampler tensors, the per-lane
remaining budget ``rem`` and each width's lane list as buffers the chunk
reads at each run, so one chunk serves any mix of requests. JAX's run-time
``step_cap`` becomes a choice of chunk: the smallest rung of the ladder
(``first_chunk``, ``chunk``, ``chunk_max``) at or above the dispatch
size; ``rem`` marks a lane done the step its budget runs out, and the
delivery clamp keeps the delivered tokens JAX's. The JAX batcher's knobs,
with its names and defaults:

- width-sliced chunks (``MIOTTS_CHUNK_SLICE``, default on): below full
  occupancy a chunk gathers the live lanes into the smallest power-of-two
  width that covers them, runs only those and scatters them back, so a
  lone request pays for one lane, not all of them. The port keeps one
  chunk per (rung, width) (``chunks``, ``_warm_chunks``) where JAX keeps
  one executable per width.
  Pad rows of a sliced chunk are distinct lanes outside the live set
  (``models/llm.py _chunk_body_sliced``).
- the fused prefill (``MIOTTS_FUSED_PREFILL``, default on): the prefill
  thread runs a group's prefill (eager, on its own stream) and its first
  ``first_chunk`` steps, then delivers those tokens at once; the worker
  attaches the lanes mid-generation (``attach_group``). The first steps
  run on one chunk per power-of-two group size k, on a k-lane state of
  ``max_ctx`` cache rows, which serves every prompt bucket.
  ``MIOTTS_FUSED_PREFILL=0`` is the unfused path: ``llm_prefill_kv``,
  the same attach, and a first chunk in the cohort.
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
chunk captured while the worker replays runs its warm-up on a throwaway
state (``_warm_state``), since a capture executes nothing.

On a mesh (``mesh=``, ``parallel/``; miotts_tpu/serving/batching.py:129-152)
the lanes split over the dp ranks in contiguous blocks, each block a state
of its own on its rank's device (``_DPRank``: its weights, replicated or a
tensor-parallel ``TPGroup``, its chunks and fused chunks, its worker and
prefill streams), and a global lane maps to (dp rank, local lane) at the
attach, ``set_lane_done`` and the reset. A dispatch runs the chunk of
every dp rank with a live lane, each on its stream, and reads their
results back into global lane order; a prefill group is one dp rank's
lanes. Width slicing is off; the fused prefill and the attach hold keep
their conditions. A new request takes a free lane of the dp rank with the
fewest lanes taken. (``llm.chunk`` runs a tensor-parallel group over
distinct cards eagerly; one whose ranks share a card is one graph.)
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
    CHAT_TEMPLATE, NO_BUDGET, GenState, LLMEngine, attach_group, chunk as make_chunk,
    finish_chunk_fetch, fused_state, init_batched_state, kv_parts, llm_prefill_kv, prefill_into,
    prefilled, set_lane_done, start_chunk_fetch,
)
from ..models.sampling import BatchSamplerParams, SamplerParams
from ..ops.cuda import graphs
from ..parallel.mesh import replicate_tree, shard_gen_state, shard_llm_weights
from ..runtime import tracing
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
    # written into the chunks' sampler buffers at the lane's attach
    sampler: SamplerParams = dataclasses.field(default_factory=SamplerParams)
    rid: int = 0  # the request's id (runtime/tracing.py), 0 for none
    t_submit: int = 0  # time.monotonic_ns() when submit began waiting for the lane


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


def _recorded(stream) -> "torch.cuda.Event | None":
    """An event recorded on ``stream`` (None without a stream)."""
    if stream is None:
        return None
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _after(event, device: torch.device, tensors) -> None:
    """``device``'s current stream waits for a prefill's ``event``, and the
    prefill's tensors there are marked as used on it."""
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for t in tensors:
        if t.device == stream.device:
            t.record_stream(stream)


class _DPRank:
    """One dp rank of the batcher: its block of ``n_lanes`` lanes as a
    state of their own on its device (a tensor-parallel group's lead), its
    weights (a dict, or a ``TPGroup``) and everything a chunk of its lanes
    runs: the sampler and budget buffers, its chunks and fused chunks
    (each under its own lock), the worker's and the prefill's streams on
    its device. Without a mesh the batcher has one, over all lanes."""

    def __init__(self, index: int, rank_id: int | None, weights, eog_ids: torch.Tensor,
                 state: GenState, device: torch.device, slicing: bool):
        self.index = index
        self.rank_id = rank_id  # the lead's logical device id (None: no mesh)
        self.w = weights
        self.eog_ids = eog_ids
        self.state = state
        self.device = device
        self.n_lanes = n = state.pos.shape[0]
        # the chunk's per-lane inputs, read by every chunk at each run: a
        # lane's sampler settings are written at its attach, ``rem`` before
        # each dispatch, a width's lane list before its run
        self.sampler = BatchSamplerParams.make(np.full(n, 0.8), np.full(n, 50), np.ones(n),
                                               np.ones(n), device)
        self.rem = torch.zeros((n,), dtype=torch.int32, device=device)
        self.lanes_bufs = ({1 << i: torch.zeros((1 << i,), dtype=torch.int64, device=device)
                            for i in range(max(0, n - 1).bit_length())} if slicing else {})
        # chunks by (rung, width), made at first use or by warm_chunk;
        # replaced whole under capture_lock, read lock-free
        self.chunks: dict[tuple[int, int], decode_graph.Chunk] = {}
        self.capture_lock = threading.Lock()
        # fused first chunks by group size k: (chunk, its sampler)
        self.fused: dict[int, tuple] = {}
        self.fused_lock = threading.Lock()
        self.warm_state: GenState | None = None
        cuda = device.type == "cuda"
        self.prefill_stream = torch.cuda.Stream(device) if cuda else None
        self.stream = torch.cuda.Stream(device) if cuda else None
        if self.stream is not None:  # the worker's stream follows the state's init
            self.stream.wait_stream(torch.cuda.current_stream(device))

    def scope(self):
        """Launches on this rank's behalf count for its logical device (a
        tensor-parallel group's forward names each of its ranks itself)."""
        return graphs.on_rank(self.rank_id) if self.rank_id is not None else contextlib.nullcontext()


class ContinuousBatcher:
    def __init__(self, engine: LLMEngine, n_lanes: int = 8, max_ctx: int = 1024,
                 chunk: int = 16, seed: int = 0, first_chunk: int | None = None, mesh=None):
        self.engine = engine
        self.cfg = engine.config
        self.mesh = mesh
        # the dispatch ladder (miotts_tpu/serving/batching.py:101-127): a
        # fresh lane's first chunk is small (its first tokens early), a
        # lane that has run a steady chunk graduates to chunk_max
        chunk = int(os.environ.get("MIOTTS_CHUNK_STEPS", chunk))
        if first_chunk is None:
            first_chunk = int(os.environ.get("MIOTTS_FIRST_CHUNK", "12"))
        self.first_chunk = max(1, min(first_chunk or chunk, chunk))
        self.chunk_max = max(chunk, int(os.environ.get("MIOTTS_CHUNK_MAX", str(2 * chunk))))
        self.ladder = tuple(sorted({self.first_chunk, chunk, self.chunk_max}))
        # dp fan-out (miotts_tpu/serving/batching.py:129-152): the lanes
        # split over the mesh's dp ranks, a contiguous block each; the
        # weights replicate on every rank, or split over tp
        # (--tensor-parallel). The engine's own B = 1 path (oversized
        # prompts) then runs on dp rank 0's weights.
        if mesh is not None:
            dp, tp = mesh.shape["dp"], mesh.shape["tp"]
            n_lanes = -(-n_lanes // dp) * dp
            if tp > 1:
                weights = shard_llm_weights(mesh, engine.weights, self.cfg)
            else:
                weights = replicate_tree(mesh, engine.weights)
            leads = [row[0] for row in mesh.devices]
            eogs = [engine.eog_ids.to(d.device) for d in leads]
            engine.weights, engine.eog_ids, engine.device = weights[0], eogs[0], leads[0].device
            state = init_batched_state(self.cfg, n_lanes, max_ctx, leads[0].device, seed)
            states = shard_gen_state(mesh, state, weights)
            del state
            rank_ids = [d.id for d in leads]
            devices = [d.device for d in leads]
        else:
            weights, eogs, rank_ids, devices = [engine.weights], [engine.eog_ids], [None], \
                [engine.device]
            states = [init_batched_state(self.cfg, n_lanes, max_ctx, engine.device, seed)]
        self.n_lanes = n_lanes
        self.max_ctx = max_ctx
        self.chunk = chunk
        self.seed = seed
        self.fused_prefill = os.environ.get("MIOTTS_FUSED_PREFILL", "1") != "0"
        # width slicing gathers lanes of one state: off on a mesh, whose
        # lanes are split over the dp ranks (miotts_tpu/serving/batching.py:193-199)
        self.slice_chunks = (mesh is None and n_lanes > 1
                             and os.environ.get("MIOTTS_CHUNK_SLICE", "1") != "0")
        self.attach_hold_s = float(os.environ.get("MIOTTS_ATTACH_HOLD_S", "1.0"))
        self.depth = max(1, int(os.environ.get("MIOTTS_CHUNK_DEPTH", "1")))
        self._attach_hold_t0: float | None = None
        # how often, and for how long, the worker held a dispatch for a
        # burst's attaches (read by chip_smoke.py, the trace script and
        # /metrics)
        self.attach_holds = 0
        self.attach_hold_ms = 0.0
        # lanes attached, and their seconds from submit to the worker's
        # attach (/metrics)
        self.attach_waits = 0
        self.attach_wait_s = 0.0
        # chunks dispatched at each width (n_lanes: full width), counted
        # once a dispatch whatever the number of dp ranks it ran on
        self.width_counts: dict[int, int] = {}
        self.ranks = [_DPRank(i, rid, w, eog, st, dev, self.slice_chunks)
                      for i, (rid, w, eog, st, dev) in enumerate(
                          zip(rank_ids, weights, eogs, states, devices))]
        self.per_rank = n_lanes // len(self.ranks)
        self.device = self.ranks[0].device
        # (bucket, k) prefill groups and (rung, width) chunks known warm;
        # frozensets replaced under _warm_lock, read lock-free
        self._warm_prefills: frozenset[tuple[int, int]] = frozenset()
        self._warm_chunks: frozenset[tuple[int, int]] = frozenset()
        self._warm_lock = threading.Lock()
        self.split_cold_until_warm = False
        self.lanes: list[_Lane | None] = [None] * n_lanes
        # attaches are queued and applied only by the worker, between
        # chunks: (dp rank, host lane list, apply(state) -> state, finish
        # list of (lane, needs set_lane_done) already delivered in the
        # fused steps, time.monotonic_ns() at the group's finish); lanes
        # are global
        self._pending: list[tuple[int, list[int], object, list, int]] = []
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
        self._thread = threading.Thread(target=self._loop, daemon=True, name="batcher-worker")
        self._thread.start()

    # dp rank 0's parts under the names of the one-state batcher (its only
    # rank without a mesh)
    state = property(lambda self: self.ranks[0].state)
    chunks = property(lambda self: self.ranks[0].chunks)
    sampler = property(lambda self: self.ranks[0].sampler)
    rem = property(lambda self: self.ranks[0].rem)
    _fused = property(lambda self: self.ranks[0].fused)
    _fused_lock = property(lambda self: self.ranks[0].fused_lock)
    _stream = property(lambda self: self.ranks[0].stream)
    _prefill_stream = property(lambda self: self.ranks[0].prefill_stream)
    _lanes_bufs = property(lambda self: self.ranks[0].lanes_bufs)
    _warm_state = property(lambda self: self.ranks[0].warm_state)

    def _where(self, lane: int) -> tuple["_DPRank", int]:
        """A global lane's dp rank and its lane there."""
        return self.ranks[lane // self.per_rank], lane % self.per_rank

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
               early_tokens: bool = True, rid: int = 0) -> GenerationHandle:
        """Queue a request's prefill on a free lane (waiting for one) and
        return its token stream; ``rid`` is the request's id, which the
        recorder's spans of its lane name (``runtime/tracing.py``)."""
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
        t_submit = time.monotonic_ns()
        with self._cv:
            while (lane_idx := self._free_lane()) is None:
                if not self._cv.wait(timeout=timeout):
                    raise TimeoutError("no free generation lane")
            self.lanes[lane_idx] = _Lane(handle=handle, n_predict=n_predict, early=early_tokens,
                                         sampler=sampler, rid=rid, t_submit=t_submit)
        t_put = tracing.now_ns()
        tracing.record("lane_wait", t_submit, t_put, rid=rid)
        self._prefill_q.put((lane_idx, ids, T, bucket, sampler.seed, rid, t_put))
        return handle

    # -- batched prefill --------------------------------------------------------

    def _prefill_loop(self) -> None:
        """Drain-style coalescing: the first queued prompt is taken
        blocking, then whatever else is already waiting joins it, one
        prefill per prompt bucket and dp rank. Every group is dispatched
        before any is finished; a group whose dispatch or finish fails
        fails only its own requests, and the thread keeps draining."""
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
            t_taken = tracing.now_ns()
            if t_taken:
                for it in items:
                    tracing.record("prefill_queue", it[6], t_taken, rid=it[5])
            groups: dict[tuple[int, int], list[tuple]] = {}
            for it in items:
                groups.setdefault((it[3], it[0] // self.per_rank), []).append(it)
            finishes: list = []
            for bucket, _rank in sorted(groups):
                group = groups[(bucket, _rank)]
                lane_idxs = [it[0] for it in group]
                try:
                    finishes.extend((lane_idxs, fin) for fin in self._prefill_group(bucket, group))
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
        steps, or not) on its dp rank and return its finish closures, which
        deliver the fused tokens and queue the group's attach for the
        worker. The lane count is padded to a power of two; pad rows carry
        an out-of-range lane, so their attach writes drop. While the
        warm-up tail runs (``split_cold_until_warm``), a group size not yet
        warm splits into the largest warm one."""
        kp = _pow2(len(group))
        if kp > 1 and self.split_cold_until_warm and (bucket, kp) not in self._warm_prefills:
            warmed = [n for (b, n) in self._warm_prefills if b == bucket and n < kp]
            if warmed:
                sub = max(warmed)
                conts: list = []
                for i in range(0, len(group), sub):
                    conts.extend(self._prefill_group(bucket, group[i:i + sub]))
                return conts
        rank = self._where(group[0][0])[0]
        toks = np.zeros((kp, bucket), np.int64)
        lens = np.ones(kp, np.int32)
        lanes = np.full(kp, rank.n_lanes, np.int64)
        seeds = np.zeros(kp, np.int64)
        for i, (lane_idx, ids, T, _b, seed, _rid, _t) in enumerate(group):
            toks[i, :T] = ids
            lens[i] = T
            lanes[i] = self._where(lane_idx)[1]
            seeds[i] = int(seed) & 0xFFFFFFFF
        fused = self._use_fused(bucket)
        try:
            if self._work_started is None:
                self._work_started = time.monotonic()
            with trace_phase("prefill_group", bucket=bucket, k=kp, fused=int(fused),
                             rids=[it[5] for it in group]):
                if fused:
                    fetch, gst, event = self._prefill_fused(toks, lens, seeds,
                                                            self._group_sampler(kp, group), rank)
                else:
                    gst, event = self._prefill(toks, lens, seeds, rank)
        except Exception as e:  # fail this group's requests; keep serving
            print(f"mio: batched prefill failed: {e!r}", file=sys.stderr)
            self._fail_unstarted([it[0] for it in group], e)
            return []

        def apply_fn(state):
            return self._attach(state, lanes, gst, event)

        def finish_group() -> None:
            out_np = n_np = done_np = None
            if fused:
                out_np, n_np, done_np = finish_chunk_fetch(fetch)
            t_done = time.monotonic_ns()
            self._last_progress = t_done / 1e9  # time.monotonic()'s clock
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
                self._pending.append((rank.index, [it[0] for it in group], apply_fn, finish,
                                      t_done))
                self._cv.notify_all()

        return [finish_group]

    def _use_fused(self, bucket: int) -> bool:
        # the group state's rows [0, bucket + first_chunk) scatter into
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

    def _prefill(self, toks: np.ndarray, lens: np.ndarray, seeds: np.ndarray,
                 rank: "_DPRank | None" = None):
        """``llm_prefill_kv`` of padded prompts on dp rank ``rank`` (default
        0), on its prefill stream: (the ``prefilled`` group state for
        ``attach_group``, the event the worker waits on or None)."""
        rank = rank or self.ranks[0]
        dev = rank.device
        with rank.scope(), _on(rank.prefill_stream), tracing.on_device():
            lengths = to_device(lens, dev)
            gst = prefilled(*llm_prefill_kv(self.cfg, rank.w, to_device(toks, dev), lengths),
                            lengths, seeds)
            return gst, _recorded(rank.prefill_stream)

    def _prefill_fused(self, toks: np.ndarray, lens: np.ndarray, seeds: np.ndarray,
                       params: list[SamplerParams], rank: "_DPRank | None" = None):
        """The prefill and first ``first_chunk`` steps of a group of k rows
        on dp rank ``rank`` (default 0), on its prefill stream: (the tokens'
        ``ChunkFetch``, the group state for ``attach_group``, the event the
        worker waits on or None). The steps run on the rank's fused chunk of
        k lanes over ``max_ctx`` rows, under its fused_lock; the group state
        handed on is a copy of that chunk's first bucket + first_chunk rows,
        since the next group may run the chunk before the worker attaches."""
        rank = rank or self.ranks[0]
        dev = rank.device
        with rank.fused_lock, rank.scope(), _on(rank.prefill_stream), tracing.on_device():
            ch, sampler = self._fused_chunk(toks.shape[0], rank)
            sampler.copy_(BatchSamplerParams.make(
                [p.temp for p in params], [p.top_k for p in params], [p.top_p for p in params],
                [p.repeat_penalty for p in params], dev))
            st = prefill_into(self.cfg, rank.w, to_device(toks, dev), to_device(lens, dev), seeds,
                              ch.state)
            fetch = start_chunk_fetch(*ch.run(), st)
            gst = st.head(min(toks.shape[1] + self.first_chunk, self.max_ctx))
            return fetch, gst, _recorded(rank.prefill_stream)

    def _fused_chunk(self, k: int, rank: "_DPRank"):
        """The fused first chunk for k lanes of ``rank`` and its sampler
        buffers, made at first use (the caller holds the rank's
        fused_lock); the chunk keeps its unbudgeted ``rem`` through its
        body."""
        entry = rank.fused.get(k)
        if entry is None:
            dev = rank.device
            sampler = BatchSamplerParams.make(np.full(k, 0.8), np.full(k, 50), np.ones(k),
                                              np.ones(k), dev)
            rem = torch.full((k,), NO_BUDGET, dtype=torch.int32, device=dev)
            ch = make_chunk(self.cfg, rank.w, rank.eog_ids, self.first_chunk, sampler,
                            fused_state(self.cfg, k, self.max_ctx, dev, w=rank.w), rem=rem)
            entry = rank.fused[k] = (ch, sampler)
        return entry

    @staticmethod
    def _attach(state, lanes, gst: GenState, event):
        """The worker's attach of a prefilled or fused group
        (``attach_group``): on CUDA its stream first waits for the prefill
        stream's event, and the group's tensors are marked as used there, so
        the prefill stream cannot reuse their memory before the copies ran.
        (A tensor-parallel rank on another card prefilled and attaches on
        that card's current stream, one stream.)"""
        if event is not None:
            _after(event, gst.logits.device, (gst.logits, *kv_parts(gst.cache_k),
                                              *kv_parts(gst.cache_v), gst.pos, gst.ring,
                                              gst.done, gst.key))
        return attach_group(state, lanes, gst)

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
        """Run one prefill group of this prompt bucket at ``n_lanes`` lanes
        on every dp rank, without a request: the fused prefill and first
        chunk when that is what submits dispatch (making the fused chunk
        for this group size at its first use), else ``llm_prefill_kv``;
        then registers (bucket, n_lanes) as warm."""
        bucket = min(bucket, self.max_ctx)
        toks = np.ones((n_lanes, bucket), np.int64)
        lens = np.full(n_lanes, min(4, bucket), np.int32)
        for rank in self.ranks:
            if self._use_fused(bucket):
                fetch, _gst, _event = self._prefill_fused(
                    toks, lens, np.zeros(n_lanes, np.int64), [SamplerParams()] * n_lanes, rank)
                finish_chunk_fetch(fetch)
            else:
                event = self._prefill(toks, lens, np.zeros(n_lanes, np.int64), rank)[1]
                if event is not None:
                    event.synchronize()
        with self._warm_lock:
            self._warm_prefills = self._warm_prefills | {(bucket, n_lanes)}

    def _pick_width(self, size: int, need: int) -> int | None:
        """The chunk width for ``need`` live lanes at rung ``size``, or None
        for the full width (miotts_tpu/serving/batching.py:522-550): the
        smallest power of two covering them; if that one is not warm but a
        wider one is, the wider one runs (a warm 2x-width chunk beats a
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
        ``width`` lanes (None or >= n_lanes: the full width) on every dp
        rank without touching live generation: a capture runs its warm-up
        on the throwaway ``warm_state``, so this may run while the worker
        serves (miotts_tpu/serving/batching.py:552-593); then registers
        (size, width) as warm. Thread-safe."""
        size = self.chunk_max if size is None else size
        width = self.n_lanes if width is None or width >= self.n_lanes else width
        for rank in self.ranks:
            self._chunk_for(rank, size, width)
        with self._warm_lock:
            self._warm_chunks = self._warm_chunks | {(size, width)}

    def release_warm_state(self) -> None:
        """Drop the throwaway warm states (a full KV cache each) once the
        warm-up tail no longer captures; a later capture makes new ones."""
        for rank in self.ranks:
            with rank.capture_lock:
                rank.warm_state = None

    def _warm_state_now(self, rank: "_DPRank") -> GenState:
        """The throwaway state of ``rank``'s state's shapes (all lanes done)
        that captures run their warm-up on; the caller holds the rank's
        capture_lock."""
        ws = rank.warm_state
        if ws is None:
            ws = rank.warm_state = init_batched_state(self.cfg, rank.n_lanes, self.max_ctx,
                                                      rank.device, self.seed, w=rank.w)
        return ws

    def _chunk_for(self, rank: "_DPRank", size: int, width: int) -> decode_graph.Chunk:
        """``rank``'s chunk of (size, width) (width >= n_lanes: the rank's
        full width) on the rank's live state, made at first use; a capture's
        warm-up runs on the rank's ``warm_state``."""
        ch = rank.chunks.get((size, width))
        if ch is not None:
            return ch
        with rank.capture_lock, rank.scope():
            ch = rank.chunks.get((size, width))
            if ch is None:
                ch = make_chunk(self.cfg, rank.w, rank.eog_ids, size, rank.sampler, rank.state,
                                rem=rank.rem,
                                lanes=rank.lanes_bufs[width] if width < self.n_lanes else None,
                                warm_state=lambda: self._warm_state_now(rank))
                rank.chunks = {**rank.chunks, (size, width): ch}
        return ch

    def _rung(self, size: int) -> int:
        """The chunk size that runs a dispatch of ``size`` steps: the
        smallest rung of the ladder at or above it."""
        return next(r for r in self.ladder if r >= size)

    def _chunk(self, rank: "_DPRank", steps: int, width: int | None,
               lanes_np: np.ndarray | None) -> tuple[torch.Tensor, torch.Tensor]:
        """One chunk of ``steps`` steps on ``rank``'s state at ``width``
        lanes (None: all), the width's lane list written first."""
        if width is not None:
            rank.lanes_bufs[width].copy_(to_device(lanes_np, rank.device))
        with rank.scope():
            return self._chunk_for(rank, steps, width or self.n_lanes).run()

    def _free_lane(self) -> int | None:
        """A free lane: the first, or, on a mesh, the first of the dp rank
        with the fewest lanes taken (requests fan out over the ranks, as
        the reference round-robins its slots over its backends)."""
        free = [i for i, lane in enumerate(self.lanes) if lane is None]
        if not free or len(self.ranks) == 1:
            return free[0] if free else None
        taken = [sum(lane is not None for lane in self.lanes[r * self.per_rank:
                                                             (r + 1) * self.per_rank])
                 for r in range(len(self.ranks))]
        return min(free, key=lambda i: (taken[i // self.per_rank], i))

    def _set_done(self, lane: int) -> None:
        """Mark a global lane done on its dp rank, on its stream."""
        rank, local = self._where(lane)
        with _on(rank.stream):
            set_lane_done(rank.state, local)

    def shutdown(self) -> None:
        self._prefill_q.put(None)
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        self._thread.join(timeout=5)
        self._prefill_thread.join(timeout=5)

    def _fail_active_lanes(self, snapshot: list[int], exc: Exception) -> None:
        """Deliver a device failure to every in-flight request and reset
        each dp rank's state (in place: the chunks own its buffers)
        so later submits start clean (miotts_tpu/serving/batching.py:628)."""
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
            for rank in self.ranks:
                try:
                    with _on(rank.stream):
                        rank.state.done.fill_(True)
                        rank.state.ring.fill_(-1)
                except Exception as e:  # a card in a sticky error state
                    print(f"mio: lane reset failed: {e!r}", file=sys.stderr)
            self._cv.notify_all()

    # -- worker loop ---------------------------------------------------------------

    def _apply_pending(self) -> None:
        """Apply the queued attaches (the caller holds _cv): a failed one
        fails its group only; lanes that finished inside their fused steps
        are freed right after their attach."""
        now = time.monotonic_ns() if self._pending else 0
        for rank_index, lane_list, apply_fn, finish, t_done in self._pending:
            rank = self.ranks[rank_index]
            rids = [self.lanes[i].rid for i in lane_list if self.lanes[i] is not None]
            try:
                with trace_phase("attach", k=len(lane_list), rids=rids), _on(rank.stream):
                    rank.state = apply_fn(rank.state)
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
                    rank.sampler.set_lane(self._where(lane_idx)[1], lane.sampler)
                    self.attach_waits += 1
                    self.attach_wait_s += (now - lane.t_submit) / 1e9
                    tracing.record("attach_wait", t_done, now, rid=lane.rid)
            for lane_idx, needs_done in finish:
                lane = self.lanes[lane_idx]
                if lane is None:
                    continue
                lane.handle._q.put(None)
                self.lanes[lane_idx] = None
                if needs_done:
                    self._set_done(lane_idx)
                self._cv.notify_all()
        self._pending.clear()

    def _dispatch(self, steps: int, width: int | None, lanes_np: np.ndarray | None,
                  rem_np: np.ndarray, live: set[int]) -> list:
        """One chunk on every dp rank with a live lane, each on its stream:
        its budgets written, its run queued and its result's read started.
        Returns [(rank, ChunkFetch)]."""
        fetches = []
        for rank in self.ranks:
            lo = rank.index * self.per_rank
            if not any(lo <= i < lo + self.per_rank for i in live):
                continue
            with _on(rank.stream):
                with tracing.on_device():
                    rank.rem.copy_(to_device(rem_np[lo:lo + self.per_rank], rank.device))
                    out, n_new = self._chunk(rank, steps, width, lanes_np)
                fetches.append((rank, start_chunk_fetch(out, n_new, rank.state)))
        return fetches

    def _finish(self, fetches: list, steps: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The dp ranks' chunk results read and joined in global lane order
        (a rank that ran no chunk reads as done, with no tokens)."""
        out_np = np.zeros((self.n_lanes, steps), np.int32)
        n_np = np.zeros(self.n_lanes, np.int32)
        done_np = np.ones(self.n_lanes, bool)
        for rank, fetch in fetches:
            lo = rank.index * self.per_rank
            o, n, d = finish_chunk_fetch(fetch)
            out_np[lo:lo + self.per_rank, :o.shape[1]] = o
            n_np[lo:lo + self.per_rank] = n
            done_np[lo:lo + self.per_rank] = d
        return out_np, n_np, done_np

    def _loop(self) -> None:
        """The worker. Every device call it makes (attach, chunk, read, lane
        done) runs on its dp rank's worker stream."""
        inflight: deque = deque()  # ([(rank, ChunkFetch)], snapshot, size, steps)
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
                        self._set_done(i)
                        self._cv.notify_all()
                # the snapshot carries the lane objects: delivery checks that
                # self.lanes[i] is still the same request
                snapshot = [(i, lane) for i, lane in enumerate(self.lanes)
                            if lane is not None and lane.started]
                # steps in flight per lane object (a lane index may have been
                # attached again; the new request owes nothing for them)
                steps_inflight: dict[int, int] = {}
                for _fetches, snap, size_k, _steps in inflight:
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
                    with trace_phase("chunk_dispatch", steps=steps, width=width or self.n_lanes,
                                     live=len(snapshot),
                                     rids=[lane.rid for _, lane in snapshot]):
                        fetches = self._dispatch(steps, width, lanes_np, rem_np,
                                                 {i for i, _ in snapshot})
                    key = (steps, width or self.n_lanes)
                    if key not in self._warm_chunks:
                        with self._warm_lock:
                            self._warm_chunks = self._warm_chunks | {key}
                    self.width_counts[key[1]] = self.width_counts.get(key[1], 0) + 1
                    inflight.append((fetches, snapshot, size, steps))
                    dispatched = True
                except Exception as e:  # device failure: fail the cohort, keep serving
                    self._fail_active_lanes(sorted({i for i, _ in snapshot} | {
                        i for chk in inflight for i, _ in chk[1]}), e)
                    inflight.clear()
                    continue
            # read the oldest chunk once the pipeline is full, or when
            # nothing new was dispatched (nothing left to overlap it with)
            if inflight and (len(inflight) > self.depth or not dispatched):
                fetches_k, snap_k, _size_k, steps_k = inflight.popleft()
                tf = time.monotonic()
                try:
                    with trace_phase("chunk_fetch", rids=[lane.rid for _, lane in snap_k]):
                        out_np, n_np, done_np = self._finish(fetches_k, steps_k)
                except Exception as e:  # device failure: fail the cohort, keep serving
                    self._fail_active_lanes(sorted({i for i, _ in snap_k} | {
                        i for chk in inflight for i, _ in chk[1]}), e)
                    inflight.clear()
                    continue
                dt_fetch = time.monotonic() - tf
                tracing.resolve_device()
                if dt_fetch > self.stall_event_s:
                    self.stall_events += 1
                self.longest_fetch_s = max(self.longest_fetch_s, dt_fetch)
                with trace_phase("chunk_deliver", rids=[lane.rid for _, lane in snap_k]):
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
                        self._set_done(i)
                    freed = True
            if freed:
                self._cv.notify_all()
