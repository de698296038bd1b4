#!/usr/bin/env python3
"""The port's multi-device server (``miotts_tpu_torch/parallel/``) on distinct
cards, held to the mesh-less server: what ``chip_smoke.py``'s one-card mesh
phase (logical ranks) cannot show.

    python3 scripts/check_torch_mesh_cards.py        # on a host of 4 cards

Writes the full-width synthetic 0.1B LLM and the 24 kHz wave codec
(``chip_smoke.LLM_WIDTHS``, ``testing.full_codec_config()``) and starts, one
after the other in this process, servers at ``-np 4 -n 64 --ctx-size 256
--warmup off``: the mesh-less one, then each mesh of the table below, for
``--llm-quant int8`` (whose tensor-parallel sums are exact int32 dots) and
for bf16. Each serves one greedy codes-only request of 64 tokens and a
round of four text requests at once (64 tokens each, 2.56 s of audio),
and prints its /mio/health, the round's seconds, K2 launches by logical
rank, where each dp rank and each codec pipeline runs and whether its
chunks replay a CUDA graph. Required (exit 1 otherwise): every int8
mesh's greedy codes equal the mesh-less server's; the bf16 meshes' common
prefix is printed (a tp rank rounds its partial sums apart; dp-only meshes
compute as one device does). Meshes: dp 4 (a graph on each card), dp 2 x
tp 2 and tp 4 (a tensor-parallel group over distinct cards runs its chunks
eagerly), dp 2 on cards 0-1 with the codec on cards 2-3
(``--codec-devices``). Needs 4 cards; prints the cards' names and power
limits.

Then sequence parallelism over the four cards (``sp_cards``): a 400-code
decode of the 24 kHz wave codec and of the full-width mel codec
(``testing.full_mel_codec_config()``, its vocoder tamed) through a
pipeline with ``sp_devices`` the four cards, each within 1e-4 of one
card's decode, K1 14 launches a decode on every card (and K4-K6 on every
card in mel mode), every decode eager (no graph spans cards), its wall ms
beside one card's eager and replayed decodes; and ``--sequence-parallel
4`` through ``cli.main``, its WAV within 2 int16 steps of one card's.

    python3 scripts/check_torch_mesh_cards.py --sp-only   # the sp case alone
"""

from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from miotts_tpu_torch.ops.cuda import build, graphs  # noqa: E402
from miotts_tpu_torch.parallel.mesh import logical_devices  # noqa: E402

MESHES = (
    ("dp4", ["--mio-backend-devices", "all"]),
    ("dp2xtp2", ["--mio-backend-devices", "all", "-tp", "2"]),
    ("tp4", ["--mio-backend-devices", "all", "-tp", "4"]),
    ("dp2 + codec on 2,3", ["--mio-backend-devices", "0,1", "--codec-devices", "2,3"]),
)


def serve(dev, tmp: Path, name: str, flags: list[str]) -> dict:
    """One server: health, the greedy request, a round of four."""
    t0 = time.perf_counter()
    with cs.environment(MIOTTS_PACKED_CACHE=str(tmp / "packed")):
        srv = cs.start_server(dev, tmp, "llm.gguf", ["-np", "4", "-n", "64", "--ctx-size", "256",
                                                     "--warmup", "off", *flags])
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/mio/health", timeout=30) as r:
            health = json.loads(r.read())
        st, _, raw, _ = cs.http_post(srv, "/mio/tts", {
            "text": cs.SERVER_TEXTS[0], "reference_key": "voice", "codes_only": True,
            "temp": 0.0, "n_predict": 64})
        if st != 200:
            raise AssertionError(f"{name}: greedy request: HTTP {st}: {raw[:300]!r}")
        r0 = dict(graphs.rank_launches)
        tr = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            res = list(ex.map(lambda i: cs.binary_tts(srv, cs.SERVER_TEXTS[i], 50 + i,
                                                      f"{name} {i}", {"n_predict": 64}),
                              range(4)))
        eng = srv.engine
        out = {"health": {k: health[k] for k in ("backend_devices", "tensor_parallel")},
               "greedy": json.loads(raw)["codes_values"],
               "round_s": time.perf_counter() - tr, "audio_s": sum(r["audio_s"] for r in res),
               "k2_by_rank": cs.rank_counts(r0).get("decode_attention", {}),
               "dp_ranks": [(str(r.device), bool(r.chunks)
                             and all(ch.captured for ch in r.chunks.values()))
                            for r in eng.batcher.ranks],
               "codec": [str(p.device) for p in eng.codec_batcher.pipelines],
               "codec_decodes": list(eng.codec_batcher.rank_decodes),
               "wall_s": time.perf_counter() - t0}
    finally:
        srv.shutdown()
    torch.cuda.empty_cache()
    print(f"[cards] {name}: " + json.dumps({k: v for k, v in out.items() if k != "greedy"}),
          flush=True)
    return out


def sp_cards(dev, tmp: Path) -> list[str]:
    """--sequence-parallel 4 over the four cards (module docstring); returns
    what failed."""
    failed = []
    codes = np.random.RandomState(15).randint(0, 12800, 400)
    emb = np.random.RandomState(0).randn(128).astype(np.float32)
    cards = logical_devices("cuda")[:4]
    for codec, gguf in (("wave", "codec.gguf"), ("mel", "mel_codec.gguf")):
        one = cs.MioTTSPipeline(tmp / gguf, dev)
        ref = [one.synthesize(codes, emb) for _ in range(3)]  # eager, capture, replay
        del one
        pipe = cs.MioTTSPipeline(tmp / gguf, dev, sp_devices=cards)
        got, by_rank = [], []
        for _ in range(3):
            r0 = dict(graphs.rank_launches)
            got.append(pipe.synthesize(codes, emb))
            by_rank.append(cs.rank_counts(r0))
        diff = max(float(np.abs(g.audio - ref[0].audio).max()) if g.audio.shape
                   == ref[0].audio.shape else float("inf") for g in got)
        kernels = ("banded_attention",) + (("conv1d", "activation1d", "resblock")
                                           if codec == "mel" else ())
        ok = (diff <= cs.SP_TOL and not pipe.use_graph and not pipe.graphs
              and all(by.get("banded_attention") == {r: cs.K1_PER_DECODE for r in range(4)}
                      and all(set(by.get(k, {})) == set(range(4)) for k in kernels)
                      for by in by_rank))
        print(f"[cards] sp=4 {codec} 400 codes over {[str(c.device) for c in cards]}: max abs vs "
              f"one card {diff:.3e} (required <= {cs.SP_TOL}); eager decodes "
              f"{', '.join(f'{g.decode_ms:.2f}' for g in got)} ms wall against one card's "
              f"eager {ref[0].decode_ms:.2f}, capture {ref[1].decode_ms:.1f}, replay "
              f"{ref[2].decode_ms:.2f} ms; launches by card {by_rank[-1]}", flush=True)
        if not ok:
            failed.append(f"sp=4 {codec}")
        del pipe
        torch.cuda.empty_cache()
    codes_txt = tmp / "sp_codes.txt"
    codes_txt.write_text("\n".join(map(str, codes)))
    wavs = {}
    for name, extra in (("one", []), ("sp4", ["--sequence-parallel", "4"])):
        wavs[name] = tmp / f"sp_{name}.wav"
        if cs.cli.main(["-mv", str(tmp / "codec.gguf"), "--tts-mio-codes-in", str(codes_txt),
                        "-emb", str(tmp / "voice.emb.gguf"), "-o", str(wavs[name])] + extra):
            failed.append(f"cli {name}")
            return failed
    (sr1, a), (sr4, b) = cs.parse_wav(wavs["one"]), cs.parse_wav(wavs["sp4"])
    steps = int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) if a.shape == b.shape \
        else -1
    print(f"[cards] cli --sequence-parallel 4: {b.size} samples @ {sr4} Hz, {steps} int16 steps "
          f"from one card's (required <= {cs.SP_PCM_STEPS})", flush=True)
    if sr1 != sr4 or not 0 <= steps <= cs.SP_PCM_STEPS:
        failed.append("cli sp=4")
    return failed


def main() -> int:
    if torch.cuda.device_count() < 4:
        print(f"needs 4 cards, found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    dev = cs.select_device("cuda")
    build.build()
    build.load_library()
    failed = []
    with tempfile.TemporaryDirectory(prefix="miotts_mesh_cards_") as d:
        tmp = Path(d)
        ccfg = cs.full_codec_config()
        cs.write_synthetic_miocodec_gguf(str(tmp / "codec.gguf"), ccfg, seed=0)
        cs.write_synthetic_llm_gguf(str(tmp / "llm.gguf"), **cs.LLM_WIDTHS)
        cs.save_embedding_gguf(tmp / "voice.emb.gguf", np.random.RandomState(0).randn(
            ccfg.decoder_adanorm_dim).astype(np.float32))
        mcfg = cs.full_mel_codec_config()
        cs.write_synthetic_mel_vocoder_gguf(str(tmp / "mel_codec.gguf"), mcfg, seed=0,
                                            ch=cs.VOCODER_CH)
        cs.tame_vocoder_weights(tmp / "mel_codec.gguf")
        failed += sp_cards(dev, tmp)
        for quant in () if "--sp-only" in sys.argv[1:] else ("int8", "bf16"):
            q = ["--llm-quant", quant]
            plain = serve(dev, tmp, f"{quant} mesh-less", q)
            for name, flags in MESHES:
                m = serve(dev, tmp, f"{quant} {name}", q + flags)
                same = cs.common_prefix(plain["greedy"], m["greedy"])
                equal = same == len(plain["greedy"]) == len(m["greedy"])
                print(f"[cards] {quant} {name}: greedy {same} of {len(m['greedy'])} codes equal "
                      f"the mesh-less server's ({'required' if quant == 'int8' else 'reported'})",
                      flush=True)
                if quant == "int8" and not equal:
                    failed.append(f"int8 {name} greedy codes")
    if failed:
        print(f"[cards] failed: {failed}", file=sys.stderr)
        return 1
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
