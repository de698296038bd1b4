"""Serving engine: model ownership and the request flows
(miotts_tpu/serving/engine.py; run_tts_request, tts-mio-server.cpp:2153-2453).

Output JSON fields and error strings are the JAX server's. Admission is a
counting slot pool (slot ids for the X-Slot header). All requests share one
pipeline and one LLM: text requests attach to lanes of the continuous
batcher (``batching.py``), synthesis calls share codec decodes through the
micro-batcher (``codec_batching.py``).

The codec pipeline runs with ``check_syncs`` off: the sync-debug mode that
the CLI keeps on a key's first, eager decode is global to the process, and
here the LLM worker and the prefill thread read from the card meanwhile.

``--warmup on`` captures the batcher's chunk graphs (each rung of the
ladder at each width), its fused first-chunk graphs, one prefill group a
prompt bucket and the codec graphs of every key a default request can
land in, at every lane count the micro-batcher decodes at (1, 2, 4, ... up
to the power of two at or above ``-np``). As in JAX, a foreground part
runs before the server listens and the rest on a background thread
(``warmup``); a key first met while serving pays an eager decode and, at
its second decode, a capture.

``--mio-backend-devices`` and ``-tp`` build a (dp, tp) mesh
(``parallel/``; ``_init_meshes``): the batcher's lanes and the codec
micro-batches split over dp, the LLM over tp; ``--codec-devices`` gives the
codec a dp mesh of its own. ``MIOTTS_LOGICAL_DEVICES=n`` presents one
device as n ranks (the one-card check of ``chip_smoke.py``).

With ``--llm-api-url`` a text request's codes come from the external LLM
(``runtime/llm_api.py``), not the batcher. ``MIOTTS_PROFILE_DIR`` starts a
``torch.profiler`` trace of the process, ``MIOTTS_SPAN_DIR`` the span
recorder (``runtime/tracing.py``); the request flows take the server's
request id (``rid``) down to the batcher's lane and the codec's queue.

With ``--tts-wavlm-model`` the pipeline also loads WavLM, and
``generate_reference`` turns a reference recording into a speaker
embedding (``pipeline.reference_to_embedding``). Its device chain runs on
the pipeline's reference stream, not behind the worker's chunk replays or
the codec decodes, and its copies go through pinned memory;
``--parallel-reference-generation`` bounds how many run at once, their
host decodes in parallel and their device chains one at a time (on CUDA a
WavLM bucket's chain is one CUDA graph after its second run, whose
buffers one chain at a time may use).
"""

from __future__ import annotations

import functools
import json
import os
import sys
import threading
import time
import uuid

import numpy as np
import torch

from ..device import select_device
from ..models import codec_graph
from ..ops.cuda import llm_fused, llm_gemv
from ..pipeline import MioTTSPipeline, pick_bucket
from ..runtime.audio_io import save_wav16
from ..runtime.codes_io import load_codes, save_codes
from ..runtime.tracing import maybe_start_profiler, trace_phase
from .state import ReferenceCache, RequestError, RequestParams, ServerConfig


def now_ms() -> float:
    return time.perf_counter() * 1e3


def check_mesh_flags(cfg: ServerConfig) -> None:
    """Raise JAX's error for ``-tp`` without ``--mio-backend-devices``, the
    one check the mesh flags allow before any device is known."""
    if max(1, cfg.tensor_parallel) > 1 and not (cfg.mio_backend_devices or "").strip():
        raise ValueError("--tensor-parallel requires --mio-backend-devices")


class SlotPool:
    """Round-robin slot acquisition (tts-mio-server.cpp:3014-3042): slot ids
    for logging/headers + admission control."""

    def __init__(self, n: int):
        self._free = list(range(n))
        self._cv = threading.Condition()

    def acquire(self, timeout: float | None = None) -> int:
        """Blocks for a free slot; with a timeout, raises RequestError 503
        when the pool stays exhausted."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with trace_phase("slot_wait", profiled=False), self._cv:
            while not self._free:
                remaining = None if deadline is None else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    raise RequestError("server is overloaded: no free synthesis slot", 503)
                self._cv.wait(remaining)
            return self._free.pop(0)

    def release(self, idx: int) -> None:
        with self._cv:
            self._free.append(idx)
            self._cv.notify()


class ServingEngine:
    def __init__(self, cfg: ServerConfig, device: torch.device | None = None):
        self.cfg = cfg
        self.device = device if device is not None else select_device()
        maybe_start_profiler()
        self.pipeline = MioTTSPipeline(cfg.model_vocoder, self.device, check_syncs=False,
                                       wavlm_path=cfg.wavlm_model or None)
        self._init_meshes(cfg)
        from .codec_batching import CodecMicroBatcher

        self.codec_batcher = CodecMicroBatcher(self.pipeline, max_batch=max(1, cfg.n_parallel),
                                               mesh=self.codec_mesh)
        self.llm = None
        self.batcher = None
        if cfg.model:
            from ..models.llm import LLMEngine
            from .batching import ContinuousBatcher

            self.llm = LLMEngine(cfg.model, self.device, quantize=(cfg.llm_quant or None))
            self.batcher = ContinuousBatcher(
                self.llm, n_lanes=max(1, cfg.n_parallel),
                max_ctx=cfg.n_ctx + cfg.n_predict + 64,
                # SSE token granularity stays sub-second (32 tokens = 1.3 s
                # of audio)
                chunk=32, seed=cfg.seed, mesh=self.mesh)
        # the LLM engine's own (B = 1) generation serves oversized prompts,
        # one at a time
        self._oversized_lock = threading.Lock()
        self.ref_cache = ReferenceCache()
        self.slots = SlotPool(max(1, cfg.n_parallel))
        n_ref = cfg.n_parallel_reference_generation or cfg.n_parallel
        self.ref_slots = SlotPool(max(1, n_ref))
        self.inflight = 0
        self.ref_gen_inflight = 0
        self.requests_total = 0
        self.errors_total = 0
        self.codes_total = 0
        self.audio_seconds_total = 0.0
        self.llm_ms_total = 0.0
        self.synth_ms_total = 0.0
        self._counter_lock = threading.Lock()
        self.reference_init_done = True
        self.warmup_bg_done = True  # False while a warm-up tail runs
        self.warmup_s = 0.0  # the foreground warm-up's seconds
        self.warmup_bg_s = 0.0  # the background tail's, once it has ended
        self.warmup_fg_calls = self.warmup_bg_calls = 0
        self._warmup_bg_thread: threading.Thread | None = None
        if cfg.reference_file_json:
            self._preload_references(cfg.reference_file_json)
        if cfg.warmup:
            self.warmup()

    def _init_meshes(self, cfg: ServerConfig) -> None:
        """The (dp, tp) mesh over ``--mio-backend-devices`` and ``-tp``
        (miotts_tpu/serving/engine.py:65-112): batch lanes and codec
        micro-batches split over dp, the LLM over tp; one device at tp 1
        is no mesh. ``--codec-devices`` gives the codec a dp-only mesh of
        its own (else it shares the LLM's), over which the micro-batcher
        replicates the codec weights."""
        from ..parallel.mesh import make_mesh, parse_backend_devices

        check_mesh_flags(cfg)
        platform = self.device.type
        self.mesh = None
        tp = max(1, cfg.tensor_parallel)
        devices = parse_backend_devices(cfg.mio_backend_devices, platform)
        if devices is not None and (len(devices) > 1 or tp > 1):
            if len(devices) % tp != 0:
                raise ValueError(f"--tensor-parallel {tp} does not divide the "
                                 f"{len(devices)} backend devices")
            self.mesh = make_mesh(devices, tp=tp)
        self.codec_mesh = self.mesh
        if cfg.codec_devices:
            cdevs = parse_backend_devices(cfg.codec_devices, platform)
            if self.mesh is not None:
                overlap = set(self.mesh.devices.reshape(-1).tolist()) & set(cdevs)
                if overlap:
                    print(f"warning: --codec-devices overlaps the LLM mesh on "
                          f"{sorted(d.id for d in overlap)} — overlap synthesis will contend "
                          "there", file=sys.stderr)
            self.codec_mesh = make_mesh(cdevs, tp=1)

    def shutdown(self) -> None:
        """Stop the batchers' threads (after the warm-up tail, if one runs)."""
        if self._warmup_bg_thread is not None:
            self._warmup_bg_thread.join()
        if self.batcher is not None:
            self.batcher.shutdown()
        self.codec_batcher.shutdown()

    # -- warm-up ----------------------------------------------------------------

    def _codec_warm_calls(self) -> list:
        """Every (bucket, options) codec key a default request can land in,
        through pick_bucket(n_predict) (miotts_tpu/serving/engine.py:197):
        full synthesis (pcm16), the streaming re-decode's window and its
        f32 full-decode fallback."""
        from ..streaming import StreamingSynthesizer

        top = pick_bucket(max(1, self.cfg.n_predict), self.pipeline.buckets)
        warm_buckets = [b for b in self.pipeline.buckets if b <= top]
        if top not in warm_buckets:
            warm_buckets.append(top)
        calls: list[tuple[int, dict]] = []
        for bucket in warm_buckets:
            calls.append((bucket, dict(pcm16=True)))
            calls.append((bucket, dict(interp_anchor=StreamingSynthesizer.INTERP_ANCHOR,
                                       peak_normalize=False, pcm16=True,
                                       wlen=StreamingSynthesizer.WINDOW_SAMPLES)))
            calls.append((bucket, dict(interp_anchor=StreamingSynthesizer.INTERP_ANCHOR,
                                       peak_normalize=False)))
        return calls

    def _llm_warm_calls(self) -> list:
        """The batcher's warm calls (miotts_tpu/serving/engine.py:230-278):
        one prefill group a prompt bucket (``(bucket, None)``), the
        power-of-two burst groups of the buckets up to 128
        (``{"prefill_lanes": k}``), and every chunk graph, each rung of the
        ladder at each width (``(rung, {"chunk_width": w})``; JAX has one
        executable a width). Empty without a local LLM."""
        if self.batcher is None:
            return []
        from .batching import _PROMPT_BUCKETS

        b = self.batcher
        max_prompt = b.max_ctx - 8
        llm_buckets = [x for x in _PROMPT_BUCKETS if x <= max_prompt] or [max(8, max_prompt)]
        calls: list[tuple[int, dict | None]] = [(x, None) for x in llm_buckets]
        # a prefill group is one dp rank's lanes at most
        burst = 1 << max(0, b.per_rank - 1).bit_length()
        ladder, g = [], 2
        while g <= burst:
            ladder.append(g)
            g *= 2
        calls += [(x, {"prefill_lanes": g}) for x in llm_buckets if x <= 128 for g in ladder]
        calls += [(rung, {"chunk_width": wd}) for rung in b.ladder for wd in b.widths()]
        return calls

    def _do_warm(self, bk) -> None:
        bucket, kw = bk
        if kw is None:
            self.batcher.warm_prefill(bucket)
        elif "prefill_lanes" in kw:
            self.batcher.warm_prefill(bucket, n_lanes=kw["prefill_lanes"])
        elif "chunk_width" in kw:
            self.batcher.warm_chunk(bucket, width=kw["chunk_width"])
        else:
            self.codec_batcher.warm(bucket, **kw)

    def _warm_is_fg(self, bk) -> bool:
        """Whether a warm call runs before the server listens
        (miotts_tpu/serving/engine.py:296-310): the small prompt buckets'
        single prefills, the chunk graphs at width 1 and at full width (the
        fallback while the other widths warm), and the codec keys up to
        MIOTTS_WARMUP_FG_BUCKET (default 256) but the f32 streaming
        fallback's."""
        bucket, kw = bk
        if kw is None:
            return bucket <= 128
        if "prefill_lanes" in kw:
            return False
        if "chunk_width" in kw:
            return kw["chunk_width"] in (1, self.batcher.n_lanes)
        if "interp_anchor" in kw and "wlen" not in kw:
            return False
        return bucket <= int(os.environ.get("MIOTTS_WARMUP_FG_BUCKET", "256"))

    def warmup(self) -> None:
        """Capture the serving graphs, split as JAX splits its warm-up
        (miotts_tpu/serving/engine.py:312-457): the foreground part
        (``_warm_is_fg``), then one real request through the fused prefill,
        attach, chunk and read, before the server listens; the rest (the
        other chunk widths first, then the burst prefill groups, the big
        prompt buckets and codec keys) on a background thread of
        MIOTTS_WARMUP_BG_POOL (default 1) workers, while the server serves.
        Meanwhile ``warmup_bg_done`` is False (``/mio/health``'s
        ``warmup_complete``) and the batcher splits a burst into warm group
        sizes and picks warm widths only. MIOTTS_WARMUP_BG=0 warms all of
        it in the foreground. Prints the foreground's time and the reserved
        device memory, and the tail's time when it ends."""
        t0 = time.perf_counter()
        codec_calls = self._codec_warm_calls()
        warm_calls = codec_calls + self._llm_warm_calls()
        fg_calls = [bk for bk in warm_calls if self._warm_is_fg(bk)]
        bg_calls = [bk for bk in warm_calls if bk not in fg_calls]
        if os.environ.get("MIOTTS_WARMUP_BG", "1") in ("0", "off"):
            fg_calls, bg_calls = warm_calls, []

        def bg_order(bk):
            bucket, kw = bk
            if kw is not None and "chunk_width" in kw:
                return (0, kw["chunk_width"], bucket)
            if kw is not None and "prefill_lanes" in kw:
                return (1, bucket, kw["prefill_lanes"])
            if kw is None:
                return (2, bucket, 0)
            return (3, bucket, 0)

        bg_calls.sort(key=bg_order)
        for bk in fg_calls:
            self._do_warm(bk)
        b = self.batcher
        if b is not None:
            from ..models.sampling import SamplerParams

            for _ in b.submit("warmup", sampler=SamplerParams(),
                              n_predict=b.first_chunk + 4).tokens():
                pass
        self.warmup_s = time.perf_counter() - t0
        self.warmup_fg_calls, self.warmup_bg_calls = len(fg_calls), len(bg_calls)
        self.warmup_bg_done = not bg_calls
        if bg_calls:
            if b is not None:
                b.split_cold_until_warm = True
            self._warmup_bg_thread = threading.Thread(target=self._warm_tail, args=(bg_calls,),
                                                      daemon=True, name="warmup-bg")
            self._warmup_bg_thread.start()
        elif b is not None:
            b.release_warm_state()
        reserved = (torch.cuda.max_memory_reserved(self.device)
                    if self.device.type == "cuda" else 0)
        n_chunk = sum(ch.captured for ch in b.chunks.values()) if b is not None else 0
        print(f"warmup: {len(fg_calls)} foreground calls ({len(self.pipeline.graphs)} codec "
              f"graphs, {n_chunk} chunk graphs) in {self.warmup_s:.1f}s; {len(bg_calls)} "
              f"warming in background; max_memory_reserved={reserved / 2**20:.0f} MiB",
              file=sys.stderr)

    def _warm_tail(self, calls: list) -> None:
        """The background part of ``warmup``: chunk widths first (the only
        users of the batcher's throwaway warm state, released right after
        them), then the rest; one failing call is logged and skipped."""
        import concurrent.futures

        tb = time.perf_counter()

        def do_warm_logged(bk):
            tw = time.perf_counter()
            try:
                self._do_warm(bk)
                print(f"warmup: bg {bk} in {time.perf_counter() - tw:.1f}s", file=sys.stderr)
            except Exception as e:
                print(f"warmup: bg {bk} FAILED after {time.perf_counter() - tw:.1f}s: {e!r}",
                      file=sys.stderr)

        is_chunk = [bk[1] is not None and "chunk_width" in bk[1] for bk in calls]
        b = self.batcher
        try:
            pool = max(1, int(os.environ.get("MIOTTS_WARMUP_BG_POOL", "1")))
            with concurrent.futures.ThreadPoolExecutor(pool) as ex:
                list(ex.map(do_warm_logged, [bk for bk, c in zip(calls, is_chunk) if c]))
                if b is not None:
                    b.release_warm_state()
                list(ex.map(do_warm_logged, [bk for bk, c in zip(calls, is_chunk) if not c]))
        finally:
            if b is not None:
                b.split_cold_until_warm = False
                b.release_warm_state()
            self.warmup_bg_s = time.perf_counter() - tb
            self.warmup_bg_done = True
        reserved = (torch.cuda.max_memory_reserved(self.device)
                    if self.device.type == "cuda" else 0)
        print(f"warmup: background tail ({len(calls)} calls) done in {self.warmup_bg_s:.1f}s; "
              f"max_memory_reserved={reserved / 2**20:.0f} MiB", file=sys.stderr)

    # -- counters ---------------------------------------------------------------

    def _count(self, attr: str, delta) -> None:
        with self._counter_lock:
            setattr(self, attr, getattr(self, attr) + delta)

    def record_request(self, out: dict, error: bool = False) -> None:
        """Accumulate served-request totals for /metrics."""
        with self._counter_lock:
            self.requests_total += 1
            if error:
                self.errors_total += 1
            self.codes_total += int(out.get("codes", 0) or 0)
            self.audio_seconds_total += float(out.get("duration_sec", 0.0) or 0.0)
            self.llm_ms_total += float(out.get("llm_ms", 0.0) or 0.0)
            self.synth_ms_total += float(out.get("synth_ms", 0.0) or 0.0)

    def metrics_text(self) -> str:
        """Prometheus text exposition of the serving counters."""
        gauges = [
            ("miotts_inflight", self.inflight, "requests currently running"),
            ("miotts_reference_generation_inflight", self.ref_gen_inflight,
             "reference generations currently running"),
            ("miotts_reference_cache_size", len(self.ref_cache), "cached speaker references"),
            ("miotts_slots", self.cfg.n_parallel, "configured worker slots"),
        ]
        counters = [
            ("miotts_requests_total", self.requests_total, "served requests"),
            ("miotts_errors_total", self.errors_total, "failed requests"),
            ("miotts_codes_total", self.codes_total, "audio codes generated"),
            ("miotts_audio_seconds_total", self.audio_seconds_total,
             "seconds of audio synthesized"),
            ("miotts_llm_ms_total", self.llm_ms_total, "milliseconds spent in LLM generation"),
            ("miotts_synth_ms_total", self.synth_ms_total,
             "milliseconds spent in codec synthesis"),
        ]
        codec, cb = codec_graph.codec, self.codec_batcher
        counters += [
            ("miotts_codec_graph_replays_total", codec.replays,
             "codec decodes replayed as a graph"),
            ("miotts_codec_eager_decodes_total", codec.eager,
             "codec decodes run eagerly (a key's first decode)"),
            ("miotts_codec_graph_captures_total", codec.captures, "codec graphs captured"),
        ]
        # (name, sum of seconds, count, help): Prometheus summaries without quantiles
        summaries = [("miotts_codec_queue_seconds", cb.queue_wait_s, cb.queue_waits,
                      "codec calls' wait from queueing to the start of their group's decode")]
        labelled = [("miotts_llm_fused_launches_total", "kernel",
                     [(k.name, k.launches) for k in llm_fused.KERNELS + llm_gemv.KERNELS],
                     "launches of the decode step's fused kernels K7-K11, graph replays counted")]
        if self.batcher is not None:
            b = self.batcher
            counters += [
                ("miotts_device_stall_events_total", b.stall_events,
                 "chunk fetches slower than MIOTTS_STALL_EVENT_S "
                 "(intermittent device-link pauses)"),
                ("miotts_batcher_attach_holds_total", b.attach_holds,
                 "dispatches held for a burst's attaches"),
            ]
            gauges.append(
                ("miotts_longest_chunk_fetch_seconds", round(b.longest_fetch_s, 3),
                 "slowest chunk fetch observed since start"))
            summaries.append(("miotts_batcher_attach_wait_seconds", b.attach_wait_s,
                              b.attach_waits, "requests' wait from submit to their lane's attach"))
            labelled.append(("miotts_batcher_chunks_total", "width", sorted(b.width_counts.items()),
                             "chunks dispatched, by width (lanes run)"))
        lines = []
        for name, val, help_ in gauges:
            lines += [f"# HELP {name} {help_}", f"# TYPE {name} gauge", f"{name} {val}"]
        for name, val, help_ in counters:
            lines += [f"# HELP {name} {help_}", f"# TYPE {name} counter", f"{name} {val}"]
        for name, label, items, help_ in labelled:
            lines += [f"# HELP {name} {help_}", f"# TYPE {name} counter"]
            lines += [f'{name}{{{label}="{k}"}} {v}' for k, v in items]
        for name, total, n, help_ in summaries:
            lines += [f"# HELP {name} {help_}", f"# TYPE {name} summary",
                      f"{name}_sum {total}", f"{name}_count {n}"]
        return "\n".join(lines) + "\n"

    # -- reference preload (tts-mio-server.cpp:2608-2629) ------------------------

    def _preload_references(self, spec: str) -> None:
        data = json.loads(spec)
        entries = data if isinstance(data, list) else [data]
        for e in entries:
            key = e.get("key") or e.get("reference_key")
            path = e.get("path") or e.get("file")
            if not key or not path:
                continue
            self.ref_cache.put(key, self.pipeline.load_embedding(path))

    # -- codes acquisition --------------------------------------------------------

    def _generate_codes(self, rp: RequestParams, out: dict, on_token=None,
                        rid: int = 0) -> list[int]:
        from ..models.sampling import SamplerParams

        t0 = now_ms()
        if self.cfg.llm_api_enabled:
            from ..runtime.llm_api import generate_audio_codes_external_cfg

            codes = generate_audio_codes_external_cfg(self.cfg, rp)
            if not codes:
                raise RequestError("token generation failed: external LLM API returned empty codes")
            out["llm_ms"] = now_ms() - t0
            return codes
        if self.llm is None:
            raise RequestError("text generation requested but LLM model is not loaded")
        sampler = SamplerParams(temp=rp.temp, top_k=rp.top_k, top_p=rp.top_p,
                                repeat_penalty=rp.repeat_penalty, seed=rp.seed)
        try:
            # only incremental consumers (SSE token stream, stream_audio,
            # overlap synthesis) ask for the small first chunk
            handle = self.batcher.submit(rp.text, sampler=sampler, n_predict=rp.n_predict,
                                         early_tokens=on_token is not None, rid=rid)
        except ValueError as e:
            if "prompt is too long" in str(e):
                # beyond the batcher's fixed KV budget: a dedicated
                # generation sized like the reference's context
                return self._generate_codes_oversized(rp, out, sampler, on_token, t0)
            raise RequestError(str(e))
        eog_set = set(int(t) for t in self.llm.eog_ids.tolist())
        tokens: list[int] = []
        try:
            for tok in handle.tokens():
                tokens.append(tok)
                if on_token is not None and not on_token(tok, len(tokens) - 1, tok in eog_set):
                    handle.cancel()
                    break
        except BaseException:
            # an exception from on_token (codec failure, client gone) must
            # free the lane
            handle.cancel()
            raise
        out["n_tokens"] = len(tokens)
        codes = self.llm.tokens_to_codes(tokens)
        if not codes:
            raise RequestError("no Mio audio codes were found in token sequence")
        out["llm_ms"] = now_ms() - t0
        return codes

    def _generate_codes_oversized(self, rp: RequestParams, out: dict, sampler, on_token,
                                  t0: float) -> list[int]:
        """Dedicated generation for prompts beyond the batcher's KV budget
        (see _generate_codes); same token-callback contract."""
        eog_set = set(int(t) for t in self.llm.eog_ids.tolist())
        tokens: list[int] = []

        def cb(tok, index, is_eog):
            tokens.append(int(tok))
            if on_token is not None:
                return on_token(int(tok), index, int(tok) in eog_set)
            return True

        with self._oversized_lock:
            self.llm.generate_audio_tokens_streaming(rp.text, cb, n_predict=rp.n_predict,
                                                     n_ctx=rp.n_ctx, sampler=sampler)
        out["n_tokens"] = len(tokens)
        codes = self.llm.tokens_to_codes(tokens)
        if not codes:
            raise RequestError("no Mio audio codes were found in token sequence")
        out["llm_ms"] = now_ms() - t0
        return codes

    # -- embedding resolution (tts-mio-server.cpp:2258-2324 order) ----------------

    def _resolve_embedding(self, rp: RequestParams) -> np.ndarray | None:
        if rp.embedding_in:
            try:
                return self.pipeline.load_embedding(rp.embedding_in)
            except Exception as e:
                raise RequestError(f"mio_tts_embedding_load_gguf failed: {e}")
        if rp.reference_key:
            embedding = self.ref_cache.get(rp.reference_key)
            if embedding is None or embedding.size == 0:
                raise RequestError(f"reference_key not found: {rp.reference_key}")
            return embedding
        if rp.reference_audio:
            raise RequestError("reference_audio is not supported in synthesis requests. "
                               "use /mio/generate_reference then reference_key")
        default_emb = rp.embedding_default_in or self.cfg.embedding_default_in
        if default_emb and self.pipeline.is_dynamic_global:
            try:
                return self.pipeline.load_embedding(default_emb)
            except Exception as e:
                raise RequestError(f"mio_tts_embedding_load_gguf (default) failed: {e}")
        return None

    # -- streaming request flow ---------------------------------------------------

    def run_streaming_request(self, rp: RequestParams, out: dict, on_token=None,
                              on_audio=None, on_codes=None, embedding: np.ndarray | None = None,
                              rid: int = 0) -> tuple[np.ndarray, int]:
        """Incremental synthesis: token generation (a batcher lane)
        interleaved with prefix re-decodes, so PCM leaves the server while
        the LLM still generates. ``on_audio(pcm)`` fires per stabilized
        chunk, ``on_token`` as in ``_generate_codes``, ``on_codes(codes)``
        once code acquisition completes. Returns (audio f32, sample_rate)
        and fills ``out`` like ``run_tts_request``."""
        from ..streaming import StreamingSynthesizer

        if embedding is None:
            embedding = self._resolve_embedding(rp)
        ss = StreamingSynthesizer(self.pipeline, embedding,
                                  synth_fn=functools.partial(self.codec_batcher.synthesize,
                                                             rid=rid),
                                  transfer_pcm16=True)
        pieces: list[np.ndarray] = []
        pending: list[int] = []
        t_synth = 0.0

        def emit_pending():
            nonlocal t_synth
            if not pending:
                return
            t0 = now_ms()
            pcm = ss.feed(pending)
            t_synth += now_ms() - t0
            pending.clear()
            if pcm.size:
                pieces.append(pcm)
                if on_audio is not None:
                    on_audio(pcm)

        token_chunk = 16
        # first audio as early as the lookahead window allows, then steady
        # chunks of token_chunk codes
        first_feed = ss.lookahead + 4

        def tok_cb(tok, index, is_eog):
            cont = True
            if on_token is not None:
                cont = on_token(tok, index, is_eog)
            code = self.llm.token_to_code_or_none(tok) if self.llm else None
            if code is not None:
                pending.append(code)
            if len(pending) >= token_chunk or (
                    ss.emitted == 0 and len(ss.codes) + len(pending) >= first_feed):
                emit_pending()
            return cont

        if rp.inline_codes:
            codes = list(rp.inline_codes)
            out["codes"] = len(codes)
        elif rp.codes_in:
            try:
                codes = load_codes(rp.codes_in)
            except (OSError, ValueError) as e:
                raise RequestError(f"mio_tts_codes_load failed: {e}")
            out["codes"] = len(codes)
        elif rp.text:
            codes = self._generate_codes(rp, out, on_token=tok_cb, rid=rid)
            out["codes"] = len(codes)
        else:
            raise RequestError("either text/prompt, codes, or codes_in is required")

        if on_codes is not None:
            on_codes(codes)
        if rp.codes_out:
            try:
                save_codes(rp.codes_out, codes)
            except (OSError, ValueError) as e:
                raise RequestError(f"mio_tts_codes_save failed: {e}")
        if not ss.codes and not pending:
            # codes that did not stream in: feed them in chunks for
            # incremental output
            for off in range(0, len(codes), token_chunk):
                pending.extend(codes[off:off + token_chunk])
                emit_pending()
        else:
            emit_pending()
        t0 = now_ms()
        tail = ss.finalize()
        t_synth += now_ms() - t0
        if tail.size:
            pieces.append(tail)
            if on_audio is not None:
                on_audio(tail)

        audio = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        sr = self.pipeline.sample_rate
        out["synth_ms"] = t_synth
        out["ok"] = True
        out["mode"] = "streaming_synthesis"
        out["sample_rate"] = sr
        out["n_audio"] = int(audio.size)
        out["duration_sec"] = audio.size / sr
        out["embedding_dim"] = int(embedding.size) if embedding is not None else 0
        out["reference_key"] = rp.reference_key
        out["key"] = rp.reference_key
        return audio, sr

    def _run_overlapped(self, rp: RequestParams, out: dict, on_token=None,
                        rid: int = 0) -> tuple[np.ndarray, int]:
        """Non-streaming response, streaming-interleaved synthesis: codec
        prefix re-decodes run while the LLM lane still generates; the
        reference's final peak normalization is applied to the whole
        result."""
        embedding = self._resolve_embedding(rp)
        if rp.embedding_out and (embedding is None or embedding.size == 0):
            raise RequestError("--embedding_out requested but no embedding available")
        audio, sr = self.run_streaming_request(rp, out, on_token=on_token, embedding=embedding,
                                               rid=rid)
        if rp.embedding_out:
            self.pipeline.save_embedding(rp.embedding_out, embedding)
        peak = float(np.max(np.abs(audio))) if audio.size else 0.0
        if peak > 0.98:
            audio = audio * np.float32(0.95 / peak)
        out["mode"] = "synthesis_overlap"
        out["codes_out"] = rp.codes_out
        out["embedding_out"] = rp.embedding_out
        return audio, sr

    # -- main request flow (run_tts_request parity) -------------------------------

    def run_tts_request(self, rp: RequestParams, out: dict, on_token=None,
                        rid: int = 0) -> tuple[np.ndarray, int] | None:
        """Fills ``out`` with the reference's JSON fields. Returns (audio,
        sample_rate) for synthesis requests (int16 PCM from a full decode),
        None for codes/embedding-only."""
        if (rp.overlap_synthesis and rp.text and not rp.inline_codes and not rp.codes_in
                and not rp.codes_only and not rp.embedding_only and not self.cfg.llm_api_enabled
                and self.llm is not None):
            return self._run_overlapped(rp, out, on_token=on_token, rid=rid)
        need_codes = (not rp.embedding_only) or rp.codes_only or bool(rp.codes_out)

        codes: list[int] | None = None
        if need_codes:
            if rp.inline_codes:
                codes = list(rp.inline_codes)
            elif rp.codes_in:
                try:
                    codes = load_codes(rp.codes_in)
                except (OSError, ValueError) as e:
                    raise RequestError(f"mio_tts_codes_load failed: {e}")
            elif rp.text:
                codes = self._generate_codes(rp, out, on_token=on_token, rid=rid)
                if not codes:
                    raise RequestError("token generation produced no audio codes")
            else:
                raise RequestError("either text/prompt, codes, or codes_in is required")

        if rp.codes_out:
            if not codes:
                raise RequestError("--codes_out requested but no codes available")
            try:
                save_codes(rp.codes_out, codes)
            except (OSError, ValueError) as e:
                raise RequestError(f"mio_tts_codes_save failed: {e}")

        embedding = self._resolve_embedding(rp)

        if rp.embedding_out:
            if embedding is None or embedding.size == 0:
                raise RequestError("--embedding_out requested but no embedding available")
            self.pipeline.save_embedding(rp.embedding_out, embedding)

        out["codes"] = len(codes) if codes else 0
        out["embedding_dim"] = int(embedding.size) if embedding is not None else 0
        out["codes_out"] = rp.codes_out
        out["embedding_out"] = rp.embedding_out
        out["reference_key"] = rp.reference_key
        out["key"] = rp.reference_key

        if rp.codes_only or rp.embedding_only:
            if rp.codes_only and codes:
                out["codes_values"] = codes
            out["ok"] = True
            out["mode"] = ("codes+embedding-only" if rp.codes_only and rp.embedding_only
                           else "codes-only" if rp.codes_only else "embedding-only")
            return None

        if not codes:
            raise RequestError("synthesis requires codes")

        t0 = now_ms()
        try:
            # micro-batched; quantized to PCM16 on the device (served as
            # WAV16 either way)
            result = self.codec_batcher.synthesize(codes, embedding, pcm16=True, rid=rid)
        except ValueError as e:
            raise RequestError(f"mio_tts_synthesize failed: {e}")
        out["synth_ms"] = now_ms() - t0
        out["ok"] = True
        out["mode"] = "synthesis"
        out["sample_rate"] = result.sample_rate
        out["n_audio"] = int(result.audio.size)
        out["duration_sec"] = result.audio.size / result.sample_rate
        return result.audio, result.sample_rate

    def run_tts_request_to_file(self, rp: RequestParams, out: dict, rid: int = 0) -> None:
        """Non-stream /mio/tts: writes a wav under output_dir like the
        reference (tts-mio-server.cpp:2420-2447)."""
        res = self.run_tts_request(rp, out, rid=rid)
        if res is None:
            return
        audio, sr = res
        output_file = rp.output_file or os.path.join(
            self.cfg.output_dir, f"mio-tts-{int(time.time() * 1000)}-{uuid.uuid4().hex[:8]}.wav")
        parent = os.path.dirname(output_file)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with trace_phase("respond", profiled=False):
            save_wav16(output_file, audio, sr)
        out["output_file"] = output_file

    # -- reference generation (voice cloning) -----------------------------------

    def generate_reference(self, audio_path: str, key: str,
                           max_reference_seconds: float) -> np.ndarray:
        """Reference audio -> embedding, cached under ``key`` (and saved to
        ``--reference-added-output-dir`` when set)."""
        emb = self.pipeline.reference_to_embedding(audio_path, max_reference_seconds)
        self.ref_cache.put(key, emb)
        if self.cfg.reference_added_output_dir:
            os.makedirs(self.cfg.reference_added_output_dir, exist_ok=True)
            self.pipeline.save_embedding(
                os.path.join(self.cfg.reference_added_output_dir, f"{key}.emb.gguf"), emb)
        return emb
