#!/usr/bin/env python3
"""Stress the port's CUDA graph captures against other threads' device work
in a server, on one NVIDIA GPU.

    python3 scripts/stress_torch_captures.py [--servers 4]

Writes full-width synthetic GGUFs (the 24 kHz wave codec with its global
encoder, the 0.1B LLM, WavLM Base+) and 2.5-25 s references from a seed,
then starts a ``--tts-wavlm-model`` server (``-np 2 -n 120 --warmup on
--parallel-reference-generation 2``) ``--servers`` times in this process.
Right after each one listens, while its warm-up tail still captures codec
and prefill graphs in the background, it sends 12 ``/mio/generate_reference``
(two WavLM buckets, so each bucket's eager chain and its capture happen
then, on the requests' own threads) and 12 text ``/mio/tts`` requests at
once. Every generation must give the in-process card embedding (within
1e-3) and every text request must succeed: a capture broken by another
thread (a device-wide synchronize, a pinned buffer's event recorded into
it, a cuBLAS or cuDNN handle made inside it) fails a request. Prints each
server's streams (all distinct) and any failure, and exits 1 on one.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from miotts_tpu_torch.device import select_device  # noqa: E402
from miotts_tpu_torch.ops.cuda import build, graphs  # noqa: E402
from miotts_tpu_torch.pipeline import MioTTSPipeline  # noqa: E402
from miotts_tpu_torch.testing import (  # noqa: E402
    full_codec_config, save_embedding_gguf, write_synthetic_llm_gguf,
    write_synthetic_miocodec_gguf)

REFS = ("ref20.wav", "ref3.flac", "ref3.wav", "ref2_5.wav")
SERVER_FLAGS = ["-np", "2", "-n", "120", "--ctx-size", "512", "--warmup", "on",
                "--parallel-reference-generation", "2"]


def one_server(dev, tmp: Path, want: dict, i: int) -> int:
    """One server, 24 requests at once; returns the number that failed."""
    srv = cs.start_server(dev, tmp, "llm.gguf",
                          [*SERVER_FLAGS, "--tts-wavlm-model", str(tmp / "wavlm.gguf")])
    eng = srv.engine
    streams = {"codec": eng.pipeline._stream, "reference": eng.pipeline._ref_stream,
               "prefill": eng.batcher._prefill_stream, "worker": eng.batcher._stream,
               "capture": graphs.capture_stream(dev)}
    ids = {k: s.cuda_stream for k, s in streams.items()}
    print(f"[server {i}] streams {ids}, all distinct: {len(set(ids.values())) == len(ids)}",
          flush=True)

    def text(n: int) -> None:
        status, _, data, _ = cs.http_post(srv, "/mio/tts", {
            "text": cs.SERVER_TEXTS[n % len(cs.SERVER_TEXTS)], "reference_key": "voice",
            "seed": 50 + n})
        if status != 200 or not json.loads(data).get("ok"):
            raise AssertionError(f"text {n}: HTTP {status} {data[:300]!r}")

    t0, failed = time.perf_counter(), 0
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            futs = []
            for k in range(3):
                futs += [ex.submit(cs.generate_reference, srv, tmp, f"s{i}_{k}_{j}", ref,
                                   j % 2 == 1, want[ref]) for j, ref in enumerate(REFS)]
                futs += [ex.submit(text, 4 * k + j) for j in range(4)]
            for f in futs:
                try:
                    f.result()
                except Exception as e:  # counted and printed; the exit code says it
                    failed += 1
                    print(f"[server {i}] FAILED: {e!r}"[:600], flush=True)
        print(f"[server {i}] {len(futs)} requests in {time.perf_counter() - t0:.1f}s, {failed} "
              f"failed; warm-up tail done: {eng.warmup_bg_done}; reference graphs "
              f"{sorted(eng.pipeline.ref_graphs)}", flush=True)
    finally:
        srv.shutdown()
    return failed


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--servers", type=int, default=4, help="servers started one after another")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("stress_torch_captures: this needs a CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = select_device("cuda")
    build.build()
    build.load_library()
    failed = 0
    with tempfile.TemporaryDirectory(prefix="miotts_stress_") as d:
        tmp = Path(d)
        ccfg = full_codec_config()
        write_synthetic_miocodec_gguf(str(tmp / "codec.gguf"), ccfg, seed=0)
        write_synthetic_llm_gguf(str(tmp / "llm.gguf"), **cs.LLM_WIDTHS)
        save_embedding_gguf(tmp / "voice.emb.gguf",
                            np.random.RandomState(0).randn(ccfg.decoder_adanorm_dim)
                            .astype(np.float32))
        cs.clone_assets(tmp)
        card = MioTTSPipeline(tmp / "codec.gguf", dev, wavlm_path=tmp / "wavlm.gguf")
        want = {ref: card.reference_to_embedding(tmp / ref) for ref in REFS}
        del card
        for i in range(args.servers):
            failed += one_server(dev, tmp, want, i)
            torch.cuda.empty_cache()
    print(f"stress: {args.servers} servers, {failed} requests failed", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
