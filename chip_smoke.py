#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (miotts_tpu_torch) through its main path on
one NVIDIA GPU and check every kernel on it.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and prints no result:

1. device: the card's name and power limit; the port's device is set to
   CUDA (TF32 off).
2. build: the CUDA kernels are compiled from ``miotts_tpu_torch/csrc``.
3. K1 (banded attention) against its plain PyTorch version on the card at
   the codec's shapes, max abs error <= 1e-5 (f32, TF32 off).
4. K2 (decode attention) against its plain version, bf16 KV cache, max abs
   error <= 2e-2 (one bf16 ulp at |x| in [2, 4) is 1.6e-2).
5. assets: synthetic GGUFs from a seed: the 24 kHz MioCodec at full width
   and the 0.1B LLM (qwen2, dim 768, 12 layers, ~151.8k vocab).
6. requests: three text -> WAV runs through ``miotts_tpu_torch.cli.main``;
   each WAV parses, has the sample count its codes imply, is not silent,
   and both kernels' launch counters grew.
7. fidelity: the same 250 codes decoded on the card and on the CPU
   (plain versions, f32): mel-L1 < 1e-2.

Before the last line it prints one JSON object with each kernel's launch
count in the requests, its error and its time against the plain version;
the last line is ``{"ok": true, "device": {...}}``. Needs no network and
writes only to a temporary directory and the kernels' build directory.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from miotts_tpu_torch import cli
from miotts_tpu_torch.device import select_device
from miotts_tpu_torch.ops.cuda import banded_attention as k1
from miotts_tpu_torch.ops.cuda import build
from miotts_tpu_torch.ops.cuda import decode_attention as k2
from miotts_tpu_torch.pipeline import MioTTSPipeline
from miotts_tpu_torch.testing import (
    full_codec_config, mel_l1, save_embedding_gguf, write_synthetic_llm_gguf,
    write_synthetic_miocodec_gguf)

K1_TOL = 1e-5
K2_TOL = 2e-2
MEL_L1_MAX = 1e-2
REQUESTS = (  # (prompt, n_predict, extra flags)
    ("Hello there.", 120, ["--temp", "0"]),
    ("The quick brown fox jumps over the lazy dog, twice.", 250, ["--seed", "1"]),
    ("A longer request: it reads a whole paragraph of text aloud, clause by clause, "
     "so that the codec decodes a long bucket of codes.", 400, ["--seed", "2", "--top-p", "0.9"]),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs, after a
    warm-up. A sleep kernel holds the stream while the host enqueues the
    runs, so the events time the device, not the Python launch overhead
    (which exceeds a small kernel's run time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_k1(dev, gen) -> dict:
    worst, rows = 0.0, []
    for B in (1, 4):
        for H, T in ((12, 256), (12, 512), (8, 512), (8, 1024)):
            q, k, v = (torch.randn(B * H, T, 64, generator=gen).to(dev) for _ in range(3))
            lens = [T - 70] if B == 1 else [T, T - 17, T - 70, T // 3]
            lengths = torch.tensor(lens, dtype=torch.int32).repeat_interleave(H).to(dev)
            got = k1.banded_attention_folded(q, k, v, lengths, 65)
            torch.cuda.synchronize()
            ref = k1.banded_attention_folded_plain(q, k, v, lengths, 65)
            err = (got - ref).abs().max().item()
            ms = cuda_ms(lambda: k1.banded_attention_folded(q, k, v, lengths, 65))
            plain = cuda_ms(lambda: k1.banded_attention_folded_plain(q, k, v, lengths, 65))
            log(f"[k1] B={B} H={H} T={T} D=64 lengths={lens}: max_abs_err={err:.3e} "
                f"kernel={ms:.4f}ms plain={plain:.4f}ms")
            if not err <= K1_TOL:
                raise AssertionError(f"K1 error {err} > {K1_TOL} at B={B} H={H} T={T}")
            worst = max(worst, err)
            rows.append((B, H, T, ms, plain))
    _, _, _, ms, plain = next(r for r in rows if r[:3] == (1, 8, 1024))
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain, "at": "B=1 H=8 T=1024 D=64"}


def check_k2(dev, gen) -> dict:
    worst, at = 0.0, {}
    S, KVH, G, HD = 700, 2, 6, 64
    for B in (1, 8):
        bf = torch.bfloat16
        q = torch.randn(B, KVH, G, HD, generator=gen).to(dev, bf)
        kc, vc = (torch.randn(B, KVH, HD, generator=gen).to(dev, bf) for _ in range(2))
        ck, cv = (torch.randn(B, S, KVH, HD, generator=gen).to(dev, bf) for _ in range(2))
        pos_l = [S - 1] if B == 1 else [0, S - 1, 1, 64, 129, 350, 511, 698]
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        args = (q, kc, vc, ck, cv, 1.0 / math.sqrt(HD), pos)
        got = k2.decode_attention(*args)
        torch.cuda.synchronize()
        ref = k2.decode_attention_plain(*args)
        err = (got.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: k2.decode_attention(*args))
        plain = cuda_ms(lambda: k2.decode_attention_plain(*args))
        log(f"[k2] B={B} S={S} KVH={KVH} G={G} HD={HD} bf16 pos={pos_l}: "
            f"max_abs_err={err:.3e} kernel={ms:.4f}ms plain={plain:.4f}ms")
        if not err <= K2_TOL:
            raise AssertionError(f"K2 error {err} > {K2_TOL} at B={B}")
        worst = max(worst, err)
        if B == 1:
            at = {"ms": ms, "plain_ms": plain, "at": f"B=1 S={S} KVH={KVH} G={G} HD={HD}"}
    return {"max_abs_err": worst, **at}


def parse_wav(path: Path) -> tuple[int, np.ndarray]:
    data = path.read_bytes()
    riff, size, wave, fmt, _, pcm, ch, sr, _, _, bits, tag, n = struct.unpack_from(
        "<4sI4s4sIHHIIHH4sI", data)
    if (riff, wave, fmt, tag, pcm, ch, bits) != (b"RIFF", b"WAVE", b"fmt ", b"data", 1, 1, 16):
        raise AssertionError(f"{path}: not a mono 16-bit PCM WAV")
    if size != 36 + n or len(data) != 44 + n:
        raise AssertionError(f"{path}: RIFF sizes do not match the file")
    return sr, np.frombuffer(data[44:], "<i2")


def run_request(i: int, tmp: Path, prompt: str, n_predict: int, extra: list[str], ccfg) -> dict:
    wav, codes_out = tmp / f"req{i}.wav", tmp / f"req{i}.codes"
    before = (k1.launches, k2.launches)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["-mv", str(tmp / "codec.gguf"), "-m", str(tmp / "llm.gguf"),
                       "-emb", str(tmp / "voice.emb.gguf"), "-p", prompt,
                       "-n", str(n_predict), "--tts-mio-codes-out", str(codes_out),
                       "-o", str(wav), *extra])
    text = err.getvalue()
    if rc != 0:
        raise AssertionError(f"request {i}: cli exited {rc}:\n{text}")
    n_codes = len(codes_out.read_text().split())
    sr, pcm = parse_wav(wav)
    frames = ccfg.stft_frames(n_codes)
    n_pad = (ccfg.n_fft - ccfg.hop_length) // 2
    want = (frames - 1) * ccfg.hop_length + ccfg.n_fft - 2 * n_pad
    if pcm.size != want:
        raise AssertionError(f"request {i}: {pcm.size} samples, {n_codes} codes imply {want}")
    if not np.any(pcm != 0):
        raise AssertionError(f"request {i}: the WAV is silent")
    grew = (k1.launches - before[0], k2.launches - before[1])
    if min(grew) <= 0:
        raise AssertionError(f"request {i}: kernel launches grew by {grew}")
    tok_s = float(re.search(r"tok/s=([0-9.]+)", text).group(1))
    n_tok = int(re.search(r"n_tokens=(\d+)", text).group(1))
    codec_ms = float(re.search(r"synth breakdown: decode=([0-9.]+)ms", text).group(1))
    log(f"[request {i}] prompt_chars={len(prompt)} n_predict={n_predict} {' '.join(extra)}: "
        f"tokens={n_tok} tok/s={tok_s} codes={n_codes} codec_ms={codec_ms} "
        f"audio_s={pcm.size / sr} k1_launches={grew[0]} k2_launches={grew[1]}")
    return {"tokens": n_tok, "tok_s": tok_s, "codec_ms": codec_ms, "audio_s": pcm.size / sr}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi.stdout.strip().splitlines()[0])
    dev = select_device("cuda")

    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.load_library()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.2f}s")

    gen = torch.Generator().manual_seed(0)
    k1_res = check_k1(dev, gen)
    k2_res = check_k2(dev, gen)

    with tempfile.TemporaryDirectory(prefix="miotts_chip_smoke_") as d:
        tmp = Path(d)
        t0 = time.perf_counter()
        ccfg = full_codec_config()
        write_synthetic_miocodec_gguf(str(tmp / "codec.gguf"), ccfg, seed=0,
                                      with_global_encoder=False)
        write_synthetic_llm_gguf(str(tmp / "llm.gguf"), n_audio=12800, dim=768, n_layers=12,
                                 n_heads=12, n_kv_heads=2, ffn=2048, seed=0,
                                 n_filler_vocab=138_700, audio_logit_scale=3.0)
        rng = np.random.RandomState(0)
        emb = rng.randn(ccfg.decoder_adanorm_dim).astype(np.float32)
        save_embedding_gguf(tmp / "voice.emb.gguf", emb)
        log(f"[assets] codec + 0.1B llm + embedding written in {time.perf_counter() - t0:.1f}s")

        k1.launches = k2.launches = 0
        for i, (prompt, n_predict, extra) in enumerate(REQUESTS):
            run_request(i, tmp, prompt, n_predict, extra, ccfg)
        launches = {"banded_attention": k1.launches, "decode_attention": k2.launches}

        codes = rng.randint(0, ccfg.vocab_size, 250)
        outs = []
        for device in (dev, torch.device("cpu")):
            res = MioTTSPipeline(tmp / "codec.gguf", device).synthesize(codes, emb)
            outs.append(res.audio)
            log(f"[fidelity] {device.type}: {res.audio.size} samples in {res.decode_ms:.1f}ms")
        if outs[0].shape != outs[1].shape or not np.all(np.isfinite(outs[0])):
            raise AssertionError("card and CPU decodes differ in shape or are not finite")
        l1 = mel_l1(outs[0], outs[1], ccfg.sample_rate)
        diff = float(np.abs(outs[0] - outs[1]).max())
        log(f"[fidelity] mel-L1(card, CPU f32) = {l1:.3e}, max abs diff = {diff:.3e}")
        if not l1 < MEL_L1_MAX:
            raise AssertionError(f"mel-L1 {l1} >= {MEL_L1_MAX}")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    kernels = []
    for name, mod, res in (("banded_attention", k1, k1_res), ("decode_attention", k2, k2_res)):
        kernels.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                        "replaces": mod.REPLACES, "launches": launches[name], **res})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
