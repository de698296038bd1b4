#!/usr/bin/env python3
"""Where a served request waits: a timeline and a device trace of the
port's HTTP server (``miotts_tpu_torch/serving/``).

    python3 scripts/trace_torch_server.py [--pairs 3] [--np 8] [--out DIR]

Writes the full-width synthetic 0.1B LLM, the 24 kHz wave codec with its
global encoder and the WavLM Base+ GGUF with its references
(``chip_smoke.LLM_WIDTHS``, ``testing.full_codec_config()``,
``chip_smoke.clone_assets``) to a temporary directory and starts the server
in this process with ``-np NP -n 250 --ctx-size 512 --warmup on
--tts-wavlm-model``. Once the warm-up's background tail has ended it sets
``MIOTTS_PROFILE_DIR=DIR`` and starts ``runtime/tracing.py``'s
``torch.profiler`` trace, which records every thread of the process (the
worker, the prefill thread, the codec thread, the HTTP handlers) and every
kernel of the card, for:

1. ``--pairs`` pairs of concurrent SSE ``stream_audio`` requests, each
   with both requests' TTFA and a timeline in ms from the pair's start,
   one line an event: each submit, each prefill group (start and end on
   the prefill thread), each chunk dispatch (steps, width, live lanes)
   and each codec group (window length, calls, which are a stream's first
   feed, the longest prefix; start and end on the codec thread);
2. a round of 4 text requests at once, then ``/mio/generate_reference`` of
   the 20 s reference alone and then beside two text requests.

Then it stops the profiler, which writes the Chrome trace
``DIR/miotts_<pid>.pt.trace.json``, and reads it back:

- the host gap between chunks: on the worker thread, from the end of a
  chunk's read (``chunk_fetch``) to the start of the next dispatch
  (``chunk_dispatch``), while the LLM's stream has nothing queued (depth 1);
- the device's busy share over the requests' span (the union of all
  kernels' intervals);
- each ``reference_chain`` range: its wall time, the device time of the
  kernels its own thread launched (by correlation id) and their span, and
  the time its thread spent in CPU ops.

Prints the card's name and power limit, then one JSON object as the last
line. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from miotts_tpu_torch.device import select_device  # noqa: E402
from miotts_tpu_torch.runtime import tracing  # noqa: E402
from miotts_tpu_torch.testing import (  # noqa: E402
    full_codec_config, save_embedding_gguf, write_synthetic_llm_gguf,
    write_synthetic_miocodec_gguf)


class Timeline:
    """Events (ms since ``start``, thread, what...) from wrapped methods."""

    def __init__(self):
        self.t0, self.events, self._lock = 0.0, [], threading.Lock()

    def start(self) -> None:
        self.t0, self.events = time.perf_counter(), []

    def add(self, *what) -> None:
        with self._lock:
            self.events.append((round((time.perf_counter() - self.t0) * 1e3, 1),
                                threading.current_thread().name, *what))

    def wrap(self, obj, name: str, tag: str, info) -> None:
        real = getattr(obj, name)

        def traced(*a, **k):
            self.add(f"{tag} start", *info(*a, **k))
            try:
                return real(*a, **k)
            finally:
                self.add(f"{tag} end")
        setattr(obj, name, traced)


def union_ms(spans) -> float:
    """The length of the union of (start, end) intervals, in the trace's µs,
    as ms."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def analyse(path: Path) -> dict:
    """Read the Chrome trace back: chunk gaps on the worker thread (the one
    thread that annotates chunk dispatches), the device's busy share over
    the ``traced_requests`` range, and each reference chain's breakdown."""
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    out: dict = {"events": len(events), "kernels": len(kernels)}

    # the host gap between chunks on the worker thread
    chunk_ann = [e for e in ann if e["name"].startswith(("chunk_dispatch", "chunk_fetch"))]
    worker = sorted(chunk_ann, key=lambda e: e["ts"])
    out["chunk_threads"] = len({e["tid"] for e in chunk_ann})
    gaps = [(b["ts"] - (a["ts"] + a["dur"])) / 1e3 for a, b in zip(worker, worker[1:])
            if a["name"] == "chunk_fetch" and b["name"].startswith("chunk_dispatch")]
    dispatch = [e["dur"] / 1e3 for e in worker if e["name"].startswith("chunk_dispatch")]
    fetch = [e["dur"] / 1e3 for e in worker if e["name"] == "chunk_fetch"]
    if gaps:
        out["chunk_gap_ms"] = {"n": len(gaps), "min": min(gaps), "median": float(np.median(gaps)),
                               "p90": float(np.percentile(gaps, 90)), "max": max(gaps)}
        out["chunk_dispatch_ms_median"] = float(np.median(dispatch))
        out["chunk_fetch_ms_median"] = float(np.median(fetch))

    # the device's busy share over the traced requests
    window = [e for e in ann if e["name"] == "traced_requests"]
    if window:
        a, b = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
        busy = [(max(a, e["ts"]), min(b, e["ts"] + e["dur"])) for e in kernels
                if e["ts"] < b and e["ts"] + e["dur"] > a]
        out["device_busy_ms"] = union_ms(busy)
        out["device_span_ms"] = (b - a) / 1e3
        out["device_busy_share"] = out["device_busy_ms"] / out["device_span_ms"]

    # each reference chain: its own kernels (by correlation with its
    # thread's runtime calls) and its thread's CPU ops
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    by_corr = {}
    for k in kernels:
        c = k.get("args", {}).get("correlation")
        if c is not None:
            by_corr[c] = k
    chains = []
    for r in (e for e in ann if e["name"] == "reference_chain"):
        a, b = r["ts"], r["ts"] + r["dur"]
        launches = [e for e in runtime if e["tid"] == r["tid"] and a <= e["ts"] <= b]
        own = [by_corr[e["args"]["correlation"]] for e in launches
               if e.get("args", {}).get("correlation") in by_corr]
        ops = [e for e in events if e.get("cat") == "cpu_op" and e["tid"] == r["tid"]
               and a <= e["ts"] <= b]
        mine = {id(e) for e in own}
        others = [(max(a, e["ts"]), min(b, e["ts"] + e["dur"])) for e in kernels
                  if id(e) not in mine and e["ts"] < b and e["ts"] + e["dur"] > a]
        chains.append({
            "wall_ms": r["dur"] / 1e3, "kernels": len(own),
            "own_device_ms": union_ms((e["ts"], e["ts"] + e["dur"]) for e in own),
            "own_kernel_span_ms": ((max(e["ts"] + e["dur"] for e in own)
                                    - min(e["ts"] for e in own)) / 1e3 if own else None),
            "thread_cpu_op_ms": union_ms((e["ts"], e["ts"] + e["dur"]) for e in ops),
            "other_kernels_busy_ms": union_ms(others)})
    out["reference_chains"] = chains
    return out


def drive(srv, tmp: Path, tl: Timeline, pairs: int, result: dict) -> None:
    """The traced requests: SSE pairs with their timelines, a round of 4,
    and generate_reference alone and beside two text requests."""
    eng = srv.engine
    for pair in range(pairs):
        tl.start()
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            res = list(ex.map(lambda i: cs.sse_audio(srv, cs.SERVER_TEXTS[i], 500 + i),
                              range(2)))
        result["ttfa_ms"].append([r["ttfa_ms"] for r in res])
        print(f"pair {pair}: TTFA {[round(t, 1) for t in result['ttfa_ms'][-1]]} ms, "
              f"first token {[round(r['first_token_ms'], 1) for r in res]} ms", flush=True)
        for ev in tl.events:
            print("  ", *ev)
    r4 = cs.concurrent_round(srv, 4, "traced round")
    result["round4_audio_s_per_s"] = r4["audio_s"] / r4["wall_s"]
    with cs.uncounted():
        want = eng.pipeline.reference_to_embedding(tmp / "ref20.wav")
    alone = cs.generate_reference(srv, tmp, "alone", "ref20.wav", False, want)
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        gen = ex.submit(cs.generate_reference, srv, tmp, "beside", "ref20.wav", False, want)
        texts = [ex.submit(cs.binary_tts, srv, cs.SERVER_TEXTS[i], 600 + i, f"text {i}")
                 for i in range(2)]
        beside = gen.result()
        [t.result() for t in texts]
    result["generate_reference_ms"] = {"alone": alone["latency_ms"],
                                       "beside_two_text": beside["latency_ms"]}
    print(f"generate_reference: {alone['latency_ms']:.1f} ms alone, "
          f"{beside['latency_ms']:.1f} ms beside two text requests", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--np", type=int, default=8)
    ap.add_argument("--out", default="build/trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_torch_server: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = select_device("cuda")
    out_dir = Path(args.out).resolve()
    tl = Timeline()
    result: dict = {"ttfa_ms": []}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        ccfg = full_codec_config()
        write_synthetic_miocodec_gguf(str(tmp / "codec.gguf"), ccfg, seed=0)
        write_synthetic_llm_gguf(str(tmp / "llm.gguf"), **cs.LLM_WIDTHS)
        emb = np.random.RandomState(0).randn(ccfg.decoder_adanorm_dim).astype(np.float32)
        save_embedding_gguf(tmp / "voice.emb.gguf", emb)
        cs.clone_assets(tmp)
        srv = cs.start_server(dev, tmp, "llm.gguf", [
            "-np", str(args.np), "-n", "250", "--ctx-size", "512", "--warmup", "on",
            "--tts-wavlm-model", str(tmp / "wavlm.gguf"), "--parallel-reference-generation", "2"])
        try:
            eng = srv.engine
            while not eng.warmup_bg_done:
                time.sleep(0.05)
            os.environ["MIOTTS_PROFILE_DIR"] = str(out_dir)
            tracing.maybe_start_profiler()
            b, cb = eng.batcher, eng.codec_batcher
            real_submit = b.submit

            def submit(text, *a, **k):
                tl.add("submit", text[:10])
                return real_submit(text, *a, **k)
            b.submit = submit
            tl.wrap(b, "_prefill_group", "prefill", lambda bucket, group: (bucket, len(group)))
            tl.wrap(b, "_chunk", "chunk", lambda steps, width, lanes_np: (
                steps, width or b.n_lanes,
                [i for i, lane in enumerate(b.lanes) if lane is not None and lane.started]))
            tl.wrap(cb, "_run_group", "codec", lambda opts, batch: (
                opts[3], len(batch), [it[5] for it in batch], max(len(it[0]) for it in batch)))
            torch.cuda.synchronize()
            with tracing.trace_phase("traced_requests"):
                drive(srv, tmp, tl, args.pairs, result)
                torch.cuda.synchronize()
        finally:
            srv.shutdown()
    path = tracing.stop_profiler()
    if path is None:
        print("trace_torch_server: no trace was written", file=sys.stderr)
        return 1
    result["trace"] = path
    result["trace_bytes"] = Path(path).stat().st_size
    result.update(analyse(Path(path)))
    print(f"chunk gaps on the worker thread (fetch end -> next dispatch), ms: "
          f"{result.get('chunk_gap_ms')}; dispatch {result.get('chunk_dispatch_ms_median')} ms, "
          f"fetch {result.get('chunk_fetch_ms_median')} ms (medians)")
    print(f"device busy {result.get('device_busy_ms')} of {result.get('device_span_ms')} ms "
          f"({result.get('device_busy_share')})")
    for c in result["reference_chains"]:
        print(f"reference_chain: {c}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
