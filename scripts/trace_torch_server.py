#!/usr/bin/env python3
"""Where a served stream's first audio waits: a timeline of the port's HTTP
server (``miotts_tpu_torch/serving/``) under pairs of concurrent SSE
``stream_audio`` requests.

    python3 scripts/trace_torch_server.py [--pairs 3] [--np 8]

Writes the full-width synthetic 0.1B LLM and 24 kHz wave codec
(``chip_smoke.LLM_WIDTHS``, ``testing.full_codec_config()``) to a temporary
directory, starts the server in this process with ``-np NP -n 250
--ctx-size 512 --warmup on`` (``chip_smoke.start_server``), then sends
``--pairs`` pairs of concurrent SSE stream_audio requests. For each pair it
prints both requests' TTFA (to their first ``audio_chunk`` event) and a
timeline in ms from the pair's start, one line an event: each submit, each
prefill group (its start and end on the prefill thread), each chunk
dispatch (its size and the lanes attached), and each codec group (its
window length, calls, which of them are a stream's first feed, and the
longest prefix; its start and end on the codec thread).

Prints the card's name and power limit, then one JSON object (the TTFAs)
as the last line. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--np", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_torch_server: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = select_device("cuda")
    tl = Timeline()
    ttfas = []
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        ccfg = full_codec_config()
        write_synthetic_miocodec_gguf(str(tmp / "codec.gguf"), ccfg, seed=0,
                                      with_global_encoder=False)
        write_synthetic_llm_gguf(str(tmp / "llm.gguf"), **cs.LLM_WIDTHS)
        save_embedding_gguf(tmp / "voice.emb.gguf",
                            np.random.RandomState(0).randn(ccfg.decoder_adanorm_dim)
                            .astype(np.float32))
        srv = cs.start_server(dev, tmp, "llm.gguf", ["-np", str(args.np), "-n", "250",
                                                     "--ctx-size", "512", "--warmup", "on"])
        try:
            b, cb = srv.engine.batcher, srv.engine.codec_batcher
            real_submit = b.submit

            def submit(text, *a, **k):
                tl.add("submit", text[:10])
                return real_submit(text, *a, **k)
            b.submit = submit
            tl.wrap(b, "_prefill", "prefill", lambda toks, lens: (list(toks.shape),))
            tl.wrap(b, "_chunk", "chunk", lambda steps: (
                steps, [i for i, lane in enumerate(b.lanes) if lane is not None and lane.started]))
            tl.wrap(cb, "_run_group", "codec", lambda opts, batch: (
                opts[3], len(batch), [it[5] for it in batch], max(len(it[0]) for it in batch)))
            for pair in range(args.pairs):
                tl.start()
                with concurrent.futures.ThreadPoolExecutor(2) as ex:
                    res = list(ex.map(lambda i: cs.sse_audio(srv, cs.SERVER_TEXTS[i], 500 + i),
                                      range(2)))
                ttfas.append([r["ttfa_ms"] for r in res])
                print(f"pair {pair}: TTFA {[round(t, 1) for t in ttfas[-1]]} ms", flush=True)
                for ev in tl.events:
                    print("  ", *ev)
        finally:
            srv.shutdown()
    print(json.dumps({"ttfa_ms": ttfas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
