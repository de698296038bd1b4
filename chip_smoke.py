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
5. K3 (Q8_0 dequant matmul) against its plain version at every (K, N) of
   the 0.1B LLM's quantized leaves, T in {1, 8, 64}, bf16 and f32 x. Both
   sum the same exact bf16 x bf16 products in f32, only in another order,
   so each output may differ by at most 2 * K * 2^-24 * sum_k |x_k w_k|
   (the worst-case rounding of two K-term f32 sums).
6. assets: synthetic GGUFs from a seed: the 24 kHz MioCodec at full width
   and the 0.1B LLM (qwen2, dim 768, 12 layers, ~151.8k vocab), once with
   f32 and once with Q8_0 matmul weights (the shipped storage).
7. requests: three text -> WAV runs through ``miotts_tpu_torch.cli.main``
   on the dense bf16 path; each WAV parses, has the sample count its codes
   imply, is not silent, and the K1 and K2 launch counters grew.
8. quantized requests on the Q8_0 GGUF: ``--llm-quant q8_0`` and
   ``output`` (K1, K2 and K3 launch counters grew), and ``int8`` (W8A8 on
   exact int8 dots: K1 and K2 grew, K3 did not).
9. fidelity: the same 250 codes decoded on the card and on the CPU
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
from miotts_tpu_torch.ops.cuda import q8_matmul as k3
from miotts_tpu_torch.pipeline import MioTTSPipeline
from miotts_tpu_torch.testing import (
    full_codec_config, mel_l1, save_embedding_gguf, synthetic_vocab, write_synthetic_llm_gguf,
    write_synthetic_miocodec_gguf)

K1_TOL = 1e-5
K2_TOL = 2e-2
MEL_L1_MAX = 1e-2
LLM_WIDTHS = dict(n_audio=12800, dim=768, n_layers=12, n_heads=12, n_kv_heads=2, ffn=2048,
                  seed=0, n_filler_vocab=138_700, audio_logit_scale=3.0)
REQUESTS = (  # (prompt, n_predict, extra flags)
    ("Hello there.", 120, ["--temp", "0"]),
    ("The quick brown fox jumps over the lazy dog, twice.", 250, ["--seed", "1"]),
    ("A longer request: it reads a whole paragraph of text aloud, clause by clause, "
     "so that the codec decodes a long bucket of codes.", 400, ["--seed", "2", "--top-p", "0.9"]),
)
QUANT_REQUESTS = (  # (prompt, n_predict, extra flags, kernels that must launch)
    ("The quick brown fox jumps over the lazy dog, twice.", 250,
     ["--llm-quant", "q8_0", "--seed", "1"], (k1, k2, k3)),
    ("Hello there.", 120, ["--llm-quant", "output", "--temp", "0"], (k1, k2, k3)),
    ("Hello there.", 120, ["--llm-quant", "int8", "--temp", "0"], (k1, k2)),
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


def k3_shapes() -> list[tuple[str, int, int]]:
    """(leaf, K, N) of every Q8_0 matmul of the 0.1B LLM at LLM_WIDTHS; the
    head's N is the vocab padded to a multiple of 128, as the loader pads."""
    w = LLM_WIDTHS
    hd = w["dim"] // w["n_heads"]
    vocab = len(synthetic_vocab(w["n_audio"], w["n_filler_vocab"])[0])
    return [("wqkv", w["dim"], (w["n_heads"] + 2 * w["n_kv_heads"]) * hd),
            ("wo", w["n_heads"] * hd, w["dim"]), ("w_gateup", w["dim"], 2 * w["ffn"]),
            ("w_down", w["ffn"], w["dim"]), ("output", w["dim"], -(-vocab // 128) * 128)]


def check_k3(dev, gen) -> dict:
    worst, rows = 0.0, {}
    for leaf, K, N in k3_shapes():
        # the kernel's inputs as the loader makes them: int8 in [-127, 127],
        # f16-representable positive scales (quantize_q8_cols)
        q = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8).to(dev)
        s = (torch.rand(K // k3.QBLOCK, N, generator=gen) * 0.02 + 1e-3).half().float().to(dev)
        # the dense bf16 weight the unquantized path multiplies by (cuBLAS)
        w_bf16 = (q.float() * s.repeat_interleave(k3.QBLOCK, dim=0)).to(torch.bfloat16)
        w_abs = w_bf16.float().abs()
        for T in (1, 8, 64):
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn(T, K, generator=gen).to(dev, dt)
                got = k3.q8_matmul(x, q, s)
                torch.cuda.synchronize()
                ref = k3.q8_matmul_plain(x, q, s)
                bound = 2 * K * 2.0 ** -24 * (x.to(torch.bfloat16).float().abs() @ w_abs)
                if got.shape != (T, N) or got.dtype != torch.float32:
                    raise AssertionError(f"K3 {leaf} T={T}: {tuple(got.shape)} {got.dtype}")
                err = (got - ref).abs()
                if not bool((err <= bound).all()):
                    raise AssertionError(f"K3 {leaf} K={K} N={N} T={T} x={dt}: error "
                                         f"{err.max().item()} exceeds its bound")
                worst = max(worst, err.max().item())
                ratio = (err / bound).max().item()
                if dt == torch.bfloat16 and T in (1, 64):
                    ms = cuda_ms(lambda: k3.q8_matmul(x, q, s))
                    plain = cuda_ms(lambda: k3.q8_matmul_plain(x, q, s))
                    dense = cuda_ms(lambda: x @ w_bf16)
                    rows[(leaf, T)] = (ms, plain, dense)
                    timing = f" kernel={ms:.4f}ms plain={plain:.4f}ms dense_bf16={dense:.4f}ms"
                else:
                    timing = ""
                log(f"[k3] {leaf} K={K} N={N} T={T} x={str(dt)[6:]} launch={k3.launch_shape(T, K, N)}: "
                    f"max_abs_err={err.max().item():.3e} err/bound<={ratio:.3e}{timing}")
        del q, s, w_bf16, w_abs
    _, K, N = k3_shapes()[-1]
    ms, plain, _ = rows[("output", 1)]
    gbs = (K * N + K // k3.QBLOCK * N * 4) / (ms * 1e-3) / 1e9
    log(f"[k3] head T=1 streams {gbs:.1f} GB/s of int8 + scales")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain, "at": f"head T=1 K={K} N={N}",
            # per leaf: [kernel, plain, dense bf16 cuBLAS] ms
            "by_leaf_ms": {f"{leaf} T={T}": [round(t, 5) for t in r] for (leaf, T), r in rows.items()}}


def parse_wav(path: Path) -> tuple[int, np.ndarray]:
    data = path.read_bytes()
    riff, size, wave, fmt, _, pcm, ch, sr, _, _, bits, tag, n = struct.unpack_from(
        "<4sI4s4sIHHIIHH4sI", data)
    if (riff, wave, fmt, tag, pcm, ch, bits) != (b"RIFF", b"WAVE", b"fmt ", b"data", 1, 1, 16):
        raise AssertionError(f"{path}: not a mono 16-bit PCM WAV")
    if size != 36 + n or len(data) != 44 + n:
        raise AssertionError(f"{path}: RIFF sizes do not match the file")
    return sr, np.frombuffer(data[44:], "<i2")


def run_request(i: str, tmp: Path, prompt: str, n_predict: int, extra: list[str], ccfg,
                model: str = "llm.gguf", kernels=(k1, k2)) -> dict:
    """One text -> WAV run through the CLI. Every module in ``kernels`` must
    launch its kernel, and no other module may."""
    wav, codes_out = tmp / f"req{i}.wav", tmp / f"req{i}.codes"
    mods = (k1, k2, k3)
    before = [m.launches for m in mods]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["-mv", str(tmp / "codec.gguf"), "-m", str(tmp / model),
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
    grew = [m.launches - b for m, b in zip(mods, before)]
    for m, g in zip(mods, grew):
        if (m in kernels) != (g > 0):
            raise AssertionError(f"request {i}: {m.__name__} launches grew by {g}")
    tok_s = float(re.search(r"tok/s=([0-9.]+)", text).group(1))
    n_tok = int(re.search(r"n_tokens=(\d+)", text).group(1))
    codec_ms = float(re.search(r"synth breakdown: decode=([0-9.]+)ms", text).group(1))
    log(f"[request {i}] {model} prompt_chars={len(prompt)} n_predict={n_predict} "
        f"{' '.join(extra)}: tokens={n_tok} tok/s={tok_s} codes={n_codes} codec_ms={codec_ms} "
        f"audio_s={pcm.size / sr} k1_launches={grew[0]} k2_launches={grew[1]} "
        f"k3_launches={grew[2]}")
    return {"tokens": n_tok, "tok_s": tok_s, "codec_ms": codec_ms, "audio_s": pcm.size / sr}


def main() -> int:
    t_start = time.perf_counter()
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
    k3_res = check_k3(dev, gen)

    with tempfile.TemporaryDirectory(prefix="miotts_chip_smoke_") as d:
        tmp = Path(d)
        t0 = time.perf_counter()
        ccfg = full_codec_config()
        write_synthetic_miocodec_gguf(str(tmp / "codec.gguf"), ccfg, seed=0,
                                      with_global_encoder=False)
        write_synthetic_llm_gguf(str(tmp / "llm.gguf"), **LLM_WIDTHS)
        write_synthetic_llm_gguf(str(tmp / "llm_q8_0.gguf"), quant="q8_0", **LLM_WIDTHS)
        rng = np.random.RandomState(0)
        emb = rng.randn(ccfg.decoder_adanorm_dim).astype(np.float32)
        save_embedding_gguf(tmp / "voice.emb.gguf", emb)
        log(f"[assets] codec + 0.1B llm (f32, Q8_0) + embedding written in "
            f"{time.perf_counter() - t0:.1f}s")

        # each path is driven with every count at 0 and read right after
        launches = {}
        for path, reqs in (("bf16", [(*r, (k1, k2)) for r in REQUESTS]),
                           ("quant", QUANT_REQUESTS)):
            k1.launches = k2.launches = k3.launches = 0
            for i, (prompt, n_predict, extra, kernels) in enumerate(reqs):
                run_request(f"{path}-{i}", tmp, prompt, n_predict, extra, ccfg,
                            "llm.gguf" if path == "bf16" else "llm_q8_0.gguf", kernels)
            launches[path] = {m: m.launches for m in (k1, k2, k3)}
            log(f"[{path} path] launches: " + " ".join(
                f"{m.__name__.rsplit('.', 1)[-1]}={n}" for m, n in launches[path].items()))

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
    for name, mod, res in (("banded_attention", k1, k1_res), ("decode_attention", k2, k2_res),
                           ("q8_matmul", k3, k3_res)):
        by_path = {path: n[mod] for path, n in launches.items()}
        kernels.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                        "replaces": mod.REPLACES, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **res})
    log(f"[total] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
