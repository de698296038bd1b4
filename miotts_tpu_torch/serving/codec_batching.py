"""Codec micro-batcher: concurrent synthesis calls share one codec decode
(miotts_tpu/serving/codec_batching.py).

Calls that land within a small gather window and share their decode
options are padded to a common length bucket and decoded as one batch of
``MioTTSPipeline.decode``, which takes B lanes of ragged lengths, windows
and per-lane window starts. On CUDA every (B, bucket, options) key is one
CUDA graph of the pipeline (``models/codec_graph.py``), so a group decodes
at B = the power of two at or above its size (``_pow2_lanes``), not at the
batcher's ``max_batch``: padding a lone request to ``max_batch`` lanes
would multiply its codec work by ``max_batch``. ``warm`` captures a key's
graphs ahead of time.

On a mesh (``mesh=``, dp ranks; miotts_tpu/serving/codec_batching.py:83-96)
``max_batch`` is rounded up to a multiple of dp and a group's calls split
over the dp ranks in contiguous blocks of ceil(n / dp), as JAX's ``P("dp")``
splits its lanes; each rank decodes its block through its own device's
pipeline (``MioTTSPipeline.replica``: the codec weights copied once to each
dp rank's card) at B = the power of two at or above the block, all ranks at the
group's one bucket, at once. So a group of n calls decodes
dp x pow2(ceil(n / dp)) lanes in all: a power of two on every rank, a
multiple of dp over the mesh. Ranks on one card share its pipeline, whose
lock runs their decodes one after the other.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from ..pipeline import MioTTSPipeline, SynthesisResult, pick_bucket
from ..runtime import tracing
from ..runtime.tracing import trace_phase


def _pow2_lanes(n_active: int) -> int:
    """The decode's lane count for a group of ``n_active`` calls."""
    return 1 << max(0, n_active - 1).bit_length()


class CodecMicroBatcher:
    def __init__(self, pipeline: MioTTSPipeline, max_batch: int = 8,
                 gather_window_s: float = 0.003, mesh=None):
        self.pipeline = pipeline
        self.mesh = mesh
        # one pipeline a dp rank: this one, or its replica on the rank's device
        self.pipelines = [pipeline]
        self._pool = None
        if mesh is not None:
            dp = mesh.shape["dp"]
            max_batch = -(-max_batch // dp) * dp
            self.pipelines = [pipeline.replica(d.device) for d in mesh.devices[:, 0]]
            if dp > 1:
                self._pool = ThreadPoolExecutor(dp, thread_name_prefix="codec-rank")
        # decodes each dp rank ran (a group decodes once on each rank with a
        # share of it)
        self.rank_decodes = [0] * len(self.pipelines)
        # calls decoded, and their seconds from synthesize's queueing to the
        # start of their group's decode (/metrics)
        self.queue_waits = 0
        self.queue_wait_s = 0.0
        self.max_batch = max_batch
        self.gather_window_s = gather_window_s
        self._q: "queue.Queue[tuple | None]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True, name="codec-batcher")
        self._thread.start()

    def synthesize(self, codes: list[int], embedding: np.ndarray | None,
                   interp_anchor: int | None = None,
                   peak_normalize: bool = True,
                   pcm16: bool = False,
                   window: tuple[int, int] | None = None,
                   priority: bool = False, rid: int = 0) -> SynthesisResult:
        """Blocking call; batches with concurrent callers that share the same
        (interp_anchor, peak_normalize, pcm16, window length) options.
        ``pcm16=True`` quantizes to 16-bit PCM on the device and brings half
        the bytes back; a full decode's ``audio`` is then int16, a window's
        is scaled back to f32 (the streaming synthesizer crossfades in
        float). ``window=(start, len)`` brings back only that slice of each
        lane. ``priority=True`` (a fresh stream's first feed) runs the group
        holding the call before same-gather groups without one; it never
        splits a group. ``rid`` is the caller's request id, which the
        recorder's spans of the call name (``runtime/tracing.py``). Raises
        like ``MioTTSPipeline.synthesize`` on invalid inputs."""
        codes_arr, embedding = self.pipeline.validate_request(codes, embedding)
        fut: Future = Future()
        wlen = None if window is None else int(window[1])
        wstart = 0 if window is None else int(window[0])
        opts = (interp_anchor, peak_normalize, pcm16, wlen)
        self._q.put((codes_arr.tolist(), embedding, opts, fut, wstart, bool(priority), rid,
                     time.monotonic_ns()))
        return fut.result()

    def warm(self, bucket: int,
             interp_anchor: int | None = None,
             peak_normalize: bool = True,
             pcm16: bool = False,
             wlen: int | None = None) -> None:
        """Capture the codec graphs ``_run_group`` replays for this (bucket,
        options), at every lane count a group decodes at (the powers of two
        up to ``_pow2_lanes(max_batch)``), without going through the gather
        queue, on each dp rank's pipeline (at the lane counts of a rank's
        block). Nothing to capture on the CPU."""
        per_rank = -(-self.max_batch // len(self.pipelines))
        for pipe in dict.fromkeys(self.pipelines):
            if not pipe.use_graph:
                continue
            for i in range(_pow2_lanes(per_rank).bit_length()):
                pipe.capture(bucket, 1 << i, interp_anchor=interp_anchor,
                             peak_normalize=peak_normalize, window=wlen, pcm16=pcm16)

    def shutdown(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    # ------------------------------------------------------------------

    def _gather(self) -> list[tuple] | None:
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.gather_window_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)  # re-post shutdown for the main loop
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._gather()
            if batch is None:
                return
            for opts, items in self._ordered_groups(batch):
                self._run_group(opts, items)

    @staticmethod
    def _ordered_groups(batch: list[tuple]) -> list[tuple[tuple, list[tuple]]]:
        """Group gathered items by option set; groups holding a priority
        item (a fresh stream's first feed) run first. Stable within each
        class, so steady feeds keep arrival order."""
        groups: dict[tuple, list[tuple]] = {}
        for item in batch:
            groups.setdefault(item[2], []).append(item)
        return sorted(groups.items(), key=lambda kv: 0 if any(it[5] for it in kv[1]) else 1)

    def _run_group(self, opts: tuple, batch: list[tuple]) -> None:
        """Decode a group: at once, or, on a mesh, each dp rank its block
        of calls (module docstring), all at the group's bucket."""
        bucket = pick_bucket(max(len(item[0]) for item in batch), self.pipeline.buckets)
        if self._pool is None:
            self._decode(0, opts, batch, bucket)
            return
        per = -(-len(batch) // len(self.pipelines))
        futures = [self._pool.submit(self._decode, r, opts, batch[r * per:(r + 1) * per], bucket)
                   for r in range(len(self.pipelines)) if batch[r * per:(r + 1) * per]]
        for fut in futures:
            fut.result()

    def _decode(self, rank: int, opts: tuple, batch: list[tuple], bucket: int) -> None:
        """One decode of ``batch`` on dp rank ``rank``'s pipeline at B = the
        power of two at or above its size; each call's result (or the
        failure) goes to its future."""
        pipe = self.pipelines[rank]
        cfg = pipe.config
        interp_anchor, peak_normalize, pcm16, wlen = opts
        t_start = time.monotonic_ns()
        for item in batch:
            self.queue_waits += 1
            self.queue_wait_s += (t_start - item[7]) / 1e9
            tracing.record("codec_queue", item[7], t_start, rid=item[6], priority=int(item[5]))
        try:
            B = _pow2_lanes(len(batch))
            tokens = np.zeros((B, bucket), np.int64)
            lengths = np.ones(B, np.int32)  # pad lanes: one zero code
            starts = np.zeros(B, np.int32)
            cond = (np.zeros((B, cfg.decoder_adanorm_dim), np.float32)
                    if cfg.dynamic_global else None)
            for i, item in enumerate(batch):
                tokens[i, :len(item[0])] = item[0]
                lengths[i] = len(item[0])
                starts[i] = item[4]
                if cond is not None:
                    cond[i] = np.asarray(item[1], np.float32).reshape(-1)
            with trace_phase("codec_group", B=B, bucket=bucket, rids=[it[6] for it in batch],
                             tags={"priority": int(any(it[5] for it in batch))}):
                audio, counts, decode_ms = pipe.decode(
                    tokens, lengths, cond, interp_anchor=interp_anchor,
                    peak_normalize=peak_normalize, window=wlen,
                    starts=starts if wlen is not None else None, pcm16=pcm16,
                    as_int16=pcm16 and wlen is None)
            tracing.resolve_device()
            self.rank_decodes[rank] += 1
            for i, item in enumerate(batch):
                n_valid = int(counts[i])
                if wlen is not None:
                    start = int(starts[i])
                    fut_audio = audio[i, :max(0, min(wlen, n_valid - start))]
                else:
                    start = 0
                    fut_audio = audio[i, :n_valid]
                item[3].set_result(SynthesisResult(
                    audio=fut_audio, sample_rate=cfg.sample_rate, decode_ms=decode_ms,
                    n_codes=len(item[0]), n_frames=n_valid // cfg.hop_length,
                    window_start=start, n_total=n_valid if wlen is not None else None))
        except Exception as e:  # deliver the failure to every waiter
            for item in batch:
                if not item[3].done():
                    item[3].set_exception(e)
