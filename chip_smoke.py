#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (miotts_tpu_torch) through its paths on one
NVIDIA GPU and check every kernel on them.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and prints no result:

1. device: the card's name and power limit; the port's device is set to
   CUDA (TF32 off).
2. build: the CUDA kernels are compiled from ``miotts_tpu_torch/csrc``.
3. K1 (banded attention) against its plain PyTorch version on the card at
   the codec's shapes, max abs error <= 1e-5 (f32, TF32 off).
4. K2 (decode attention) against its plain version, bf16 KV cache, max abs
   error <= 2e-2 (one bf16 ulp at |x| in [2, 4) is 1.6e-2), at B = 1 and
   at B = 8 with ragged positions, among them 0, the edges of the split
   ranges and a full cache; timed beside SDPA over the same cache prefix
   at B = 1 and pos 128, 450 and 699.
5. K3 (Q8_0 dequant matmul) against its plain version at every (K, N) of
   the 0.1B LLM's quantized leaves, T in {1, 8, 64}, bf16 and f32 x. Both
   sum the same exact bf16 x bf16 products in f32, only in another order,
   so each output may differ by at most 2 * K * 2^-24 * sum_k |x_k w_k|
   (the worst-case rounding of two K-term f32 sums). Two calls give
   bit-equal results (at T = 64 over K splits summed in a cluster). Timed
   at T = 1 and 64 at every leaf beside its bound and the dense bf16 cuBLAS
   GEMM on the same leaf; each line names the kernel's launch plan.
6. K4 (vocoder conv1d) against its plain version at the mel path's shapes
   (C = 128, T up to 491 520, k in {3, 7}, d in {1, 3, 5}, ragged lengths
   at B = 1 and 2) and the short route's (T = 640, k = 3, d in {1, 3, 5},
   with a residual): two f32 sums of K = k*C terms plus bias and residual,
   so each output within 2 (K + 2) 2^-24 (sum |x w| + |b| + |res|). Timed
   at the last stage's noise conv and at 640 rows, beside F.conv1d.
7. K5 (anti-aliased snake) against its plain version at the same shapes:
   |err| <= 2e-6 + 1e-5 |ref| (the JAX package's own bound for this
   kernel, tests/test_vocoder.py:186; no long sums).
8. K6 (fused resblock layer) against its plain version at the same shapes
   and d in {1, 3, 5}: max abs error <= 4e-5 (the JAX package's 2e-5 at
   C = 64, tests/test_resblock_fused.py:58, doubled for C = 128's twice
   longer sums); and the same signal in a bucket 480 rows longer gives
   bit-equal valid rows and zeros beyond; also its small-tile plan (k=11)
   and its generic-tap activation (16/20 taps). Timed at the rows of each
   of the five vocoder stages of a 400-code request, each beside its bound.
9. assets: synthetic GGUFs from a seed: the 24 kHz MioCodec at full width
   in wave mode and in mel mode (100 mels, the 5x4x4x3x2 vocoder at 128
   channels, bench.py's geometry; its vocoder weights scaled by fixed
   factors so the signal stays in range, testing.tame_vocoder_weights) and the 0.1B
   LLM (qwen2, dim 768, 12 layers, ~151.8k vocab), once with f32 and once
   with Q8_0 matmul weights.
10. requests: three text -> WAV runs through ``miotts_tpu_torch.cli.main``
    on the dense bf16 path; each WAV parses, has the sample count its codes
    imply, is not silent, and only the K1 and K2 launch counters grew.
11. quantized requests on the Q8_0 GGUF: ``--llm-quant q8_0`` and
    ``output`` (K1, K2 and K3 grew), and ``int8`` (W8A8 on exact int8
    dots: K1 and K2 grew, K3 did not).
12. mel requests on the mel codec: text -> WAV at -n 250, and codes -> WAV
    with 40 and with 400 codes; each WAV has stft_frames(n) * 480 samples
    (the vocoder's count), is not silent and has at most 1% of its samples
    at full scale; K1, K4, K5 and K6 grew (K2
    only in the text request), K4-K6 by exactly the launches the vocoder's
    dispatch rules give for the request's bucket.
13. fidelity: the same 250 codes through the wave codec and the same 64
    codes through the mel codec, each decoded on the card and on the CPU
    (plain versions, f32): mel-L1 < 1e-2.

Before the last line it prints one JSON object with each kernel's launch
count in the request paths (each path driven with every count at 0), its
error, its time, its plain version's time, its bound (the least time the
card could take: bytes over 3.35 TB/s or operations over the peak rate of
their type, whichever is larger, from this run's inputs) and one PyTorch
call's time where one computes the same function; the last line is
``{"ok": true, "device": {...}}``. Needs no network and writes only to a
temporary directory and the kernels' build directory.
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
import torch.nn.functional as F

from miotts_tpu_torch import cli
from miotts_tpu_torch.device import select_device
from miotts_tpu_torch.ops.cuda import activation1d as k5
from miotts_tpu_torch.ops.cuda import banded_attention as k1
from miotts_tpu_torch.ops.cuda import build
from miotts_tpu_torch.ops.cuda import conv1d as k4
from miotts_tpu_torch.ops.cuda import decode_attention as k2
from miotts_tpu_torch.ops.cuda import q8_matmul as k3
from miotts_tpu_torch.ops.cuda import resblock as k6
from miotts_tpu_torch.pipeline import MioTTSPipeline, pick_bucket
from miotts_tpu_torch.testing import (
    full_codec_config, full_mel_codec_config, mel_l1, save_embedding_gguf, synthetic_vocab,
    tame_vocoder_weights, write_synthetic_llm_gguf, write_synthetic_mel_vocoder_gguf,
    write_synthetic_miocodec_gguf)

MODS = (k1, k2, k3, k4, k5, k6)
K1_TOL = 1e-5
K2_TOL = 2e-2
K5_ATOL, K5_RTOL = 2e-6, 1e-5
K6_TOL = 4e-5
MEL_L1_MAX = 1e-2
# NVIDIA H100 SXM data sheet: HBM3 rate, f32 outside the tensor cores, dense bf16
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
VOCODER_CH = 128
# (B, T, lengths) of the vocoder kernels' checks: stage 1 of a 400-code
# request (bucket 512: 5 120 rows, 4 000 valid), a ragged pair, and the last
# stage (491 520 rows, 384 000 valid), where each kernel is timed
VOC_SHAPES = ((1, 5120, [4000]), (2, 2560, [2560, 1777]), (1, 491520, [384000]))
# K6 timed at each vocoder stage of a 400-code request: (padded rows, valid rows)
K6_STAGES = ((5120, 4000), (20480, 16000), (81920, 64000), (245760, 192000), (491520, 384000))
MEL_CLIPPED_MAX = 0.01  # share of a mel request's samples at full scale
MEL_REQUESTS = (  # (name, extra flags, kernels that must launch)
    ("text-250", ["-m", "llm.gguf", "-p", "The quick brown fox jumps over the lazy dog, twice.",
                  "-n", "250", "--seed", "1"], (k1, k2, k4, k5, k6)),
    ("codes-40", ["--tts-mio-codes-in", "codes40.txt"], (k1, k4, k5, k6)),
    ("codes-400", ["--tts-mio-codes-in", "codes400.txt"], (k1, k4, k5, k6)),
)
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


def least_time(nbytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take: the bytes the function must move
    over the memory rate, or its operations over ``peak``, the larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    # the yardstick at B=1 H=8 T=1024: one SDPA call with the kernel's mask
    # (|k - q| <= 32 and k < length, or k == q); bound from the keys admitted
    H, T, D = 8, 1024, 64
    q, k, v = (torch.randn(H, T, D, generator=gen).to(dev) for _ in range(3))
    lengths = torch.full((H,), T - 70, dtype=torch.int32, device=dev)
    i = torch.arange(T, device=dev)
    mask = (((i[None, :] - i[:, None]).abs() <= 32)[None]
            & (i[None, None, :] < lengths[:, None, None])
            | torch.eye(T, dtype=torch.bool, device=dev)[None])
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    diff = (F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            - k1.banded_attention_folded(q, k, v, lengths, 65)).abs().max().item()
    nbytes = 4 * 4 * H * T * D + 4 * H  # q, k, v in, out; lengths
    ops = 4 * D * int(mask.sum())  # score and value FMAs of each admitted pair
    log(f"[k1] library SDPA (band mask) B=1 H=8 T=1024: {lib:.4f}ms, max diff to K1 {diff:.3e}")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain,
            **least_time(nbytes, ops, F32_FLOP_S),
            "library_ms": lib, "at": "B=1 H=8 T=1024 D=64, length 954"}


def check_k2(dev, gen) -> dict:
    worst, at, by_pos = 0.0, {}, {}
    S, KVH, G, HD = 700, 2, 6, 64
    bf = torch.bfloat16
    # one lane at the cache's end; ragged lanes; the empty cache, the edges
    # of the 88-row split ranges and a full cache
    for B, pos_l in ((1, [S - 1]), (8, [0, S - 1, 1, 64, 129, 350, 511, 698]),
                     (8, [0, 1, 87, 88, 89, 176, S - 1, S])):
        q = torch.randn(B, KVH, G, HD, generator=gen).to(dev, bf)
        kc, vc = (torch.randn(B, KVH, HD, generator=gen).to(dev, bf) for _ in range(2))
        ck, cv = (torch.randn(B, S, KVH, HD, generator=gen).to(dev, bf) for _ in range(2))
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        args = (q, kc, vc, ck, cv, 1.0 / math.sqrt(HD), pos)
        got = k2.decode_attention(*args)
        torch.cuda.synchronize()
        ref = k2.decode_attention_plain(*args)
        err = (got.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: k2.decode_attention(*args))
        plain = cuda_ms(lambda: k2.decode_attention_plain(*args))
        log(f"[k2] B={B} S={S} KVH={KVH} G={G} HD={HD} bf16 pos={pos_l} "
            f"launch={k2.launch_shape(B, S, KVH)}: max_abs_err={err:.3e} kernel={ms:.4f}ms "
            f"plain={plain:.4f}ms")
        if not err <= K2_TOL:
            raise AssertionError(f"K2 error {err} > {K2_TOL} at B={B} pos={pos_l}")
        worst = max(worst, err)
        if B > 1:
            continue
        # B=1 at the positions a 400-token request crosses: kernel, plain and
        # one SDPA call over the same cache prefix
        for p in (128, 450, S - 1):
            pos = torch.full((1,), p, dtype=torch.int32, device=dev)
            args = (q, kc, vc, ck, cv, 1.0 / math.sqrt(HD), pos)
            ms = cuda_ms(lambda: k2.decode_attention(*args))
            plain = cuda_ms(lambda: k2.decode_attention_plain(*args))
            keys = torch.cat([ck[:, :p], kc[:, None]], 1).transpose(1, 2).contiguous()
            vals = torch.cat([cv[:, :p], vc[:, None]], 1).transpose(1, 2).contiguous()
            qh = q.reshape(B, KVH * G, 1, HD)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(qh, keys, vals, enable_gqa=True))
            nbytes = 2 * (2 * (p + 1) * KVH * HD + KVH * G * HD) + 2 * KVH * G * HD + 4
            ops = 4 * (p + 1) * KVH * G * HD
            bound = least_time(nbytes, ops, BF16_FLOP_S)
            log(f"[k2] B=1 S={S} pos={p} launch={k2.launch_shape(B, S, KVH)}: kernel={ms:.4f}ms "
                f"plain={plain:.4f}ms SDPA(cache prefix, GQA)={lib:.4f}ms "
                f"bound={bound['bound_ms']:.5f}ms ({bound['bound_by']})")
            by_pos[f"pos {p}"] = [round(ms, 5), round(plain, 5), round(lib, 5)]
            at = {"ms": ms, "plain_ms": plain, **bound, "library_ms": lib,
                  "at": f"B=1 S={S} KVH={KVH} G={G} HD={HD}, pos {p}; library = SDPA over "
                  f"the cache prefix, GQA"}
    # per position: [kernel, plain, SDPA] ms
    return {"max_abs_err": worst, **at, "by_pos_ms": by_pos}


def k3_shapes() -> list[tuple[str, int, int]]:
    """(leaf, K, N) of every Q8_0 matmul of the 0.1B LLM at LLM_WIDTHS; the
    head's N is the vocab padded to a multiple of 128, as the loader pads."""
    w = LLM_WIDTHS
    hd = w["dim"] // w["n_heads"]
    vocab = len(synthetic_vocab(w["n_audio"], w["n_filler_vocab"])[0])
    return [("wqkv", w["dim"], (w["n_heads"] + 2 * w["n_kv_heads"]) * hd),
            ("wo", w["n_heads"] * hd, w["dim"]), ("w_gateup", w["dim"], 2 * w["ffn"]),
            ("w_down", w["ffn"], w["dim"]), ("output", w["dim"], -(-vocab // 128) * 128)]


def k3_bound(T: int, K: int, N: int) -> dict:
    """K3's least time: q, s and bf16 x read once, f32 y written once; or
    2 T K N operations at the bf16 peak."""
    nbytes = K * N + K // k3.QBLOCK * N * 4 + 2 * T * K + 4 * T * N
    return least_time(nbytes, 2 * T * K * N, BF16_FLOP_S)


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
                plan = k3.launch_shape(T, K, N, x.element_size())
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
                if not torch.equal(k3.q8_matmul(x, q, s), got):
                    raise AssertionError(f"K3 {leaf} T={T} x={dt}: two calls differ ({plan.kind} "
                                         f"path, {plan.z} K splits)")
                worst = max(worst, err.max().item())
                ratio = (err / bound).max().item()
                if dt == torch.bfloat16 and T in (1, 64):
                    ms = cuda_ms(lambda: k3.q8_matmul(x, q, s))
                    plain = cuda_ms(lambda: k3.q8_matmul_plain(x, q, s))
                    dense = cuda_ms(lambda: x @ w_bf16)
                    lb = k3_bound(T, K, N)
                    rows[(leaf, T)] = (ms, plain, dense, lb["bound_ms"])
                    timing = (f" kernel={ms:.4f}ms plain={plain:.4f}ms dense_bf16={dense:.4f}ms "
                              f"bound={lb['bound_ms']:.5f}ms ({lb['bound_by']})")
                else:
                    timing = ""
                log(f"[k3] {leaf} K={K} N={N} T={T} x={str(dt)[6:]} launch={tuple(plan)}: "
                    f"max_abs_err={err.max().item():.3e} err/bound<={ratio:.3e}"
                    f" bit-stable{timing}")
        del q, s, w_bf16, w_abs
    _, K, N = k3_shapes()[-1]
    ms, plain, dense, _ = rows[("output", 1)]
    gbs = (K * N + K // k3.QBLOCK * N * 4) / (ms * 1e-3) / 1e9
    log(f"[k3] head T=1 streams {gbs:.1f} GB/s of int8 + scales")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain, **k3_bound(1, K, N),
            "library_ms": dense, "at": f"head T=1 K={K} N={N}; library = dense bf16 cuBLAS GEMV",
            # per leaf: [kernel, plain, dense bf16 cuBLAS, bound] ms
            "by_leaf_ms": {f"{leaf} T={T}": [round(t, 5) for t in r]
                           for (leaf, T), r in rows.items()}}


def voc_inputs(dev, gen, B: int, T: int, lens: list[int]):
    """x [B, T, 128] (scale 0.4) zero at t >= length, and lengths, on the card."""
    L = torch.tensor(lens, dtype=torch.int32)
    x = torch.randn(B, T, VOCODER_CH, generator=gen) * 0.4
    x = x * (torch.arange(T)[None, :, None] < L[:, None, None])
    return x.to(dev), L.to(dev)


def voc_act(dev, gen) -> dict:
    """One activation as the synthetic vocoder writes it: 12-tap Hann
    filters, alpha/beta ~ 0.1 randn."""
    f = torch.hann_window(14, periodic=False, dtype=torch.float64)[1:-1]
    f = (f / f.sum()).float()
    return {"alpha": (torch.randn(VOCODER_CH, generator=gen) * 0.1).to(dev),
            "beta": (torch.randn(VOCODER_CH, generator=gen) * 0.1).to(dev),
            "up_filter": f.to(dev), "down_filter": f.to(dev)}


def k4_case(x, L, lens, w, b, d: int, res) -> tuple[float, float]:
    """K4 against its plain version on one input: (max abs error, error
    over its sum-order bound); fails past the bound."""
    B, T, C = x.shape
    k = w.shape[-1]
    got = k4.conv1d_same(x, L, w, b, d, res)
    torch.cuda.synchronize()
    ref = k4.conv1d_same_plain(x, L, w, b, d, res)
    mag = k4.conv1d_same_plain(x.abs(), L, w.abs(), b.abs(), d, None if res is None else res.abs())
    tol = 2 * (k * C + 2) * 2.0 ** -24 * mag
    err = (got - ref).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"K4 B={B} T={T} k={k} d={d}: error {err.max().item()} "
                             f"exceeds its bound")
    ratio = (err / tol.clamp(min=1e-30)).max().item()
    log(f"[k4] B={B} T={T} C={C} k={k} d={d} lengths={lens} residual={res is not None}: "
        f"max_abs_err={err.max().item():.3e} err/bound<={ratio:.3e}")
    return err.max().item(), ratio


def k4_timing(x, L, lens, w, b, d: int, res) -> dict:
    """Kernel, plain and F.conv1d times of one K4 call, with its bound."""
    B, T, C = x.shape
    k = w.shape[-1]
    ms = cuda_ms(lambda: k4.conv1d_same(x, L, w, b, d, res))
    plain = cuda_ms(lambda: k4.conv1d_same_plain(x, L, w, b, d, res))
    xc = x.transpose(1, 2).contiguous()  # the library's [B, C, T] layout
    lib = cuda_ms(lambda: F.conv1d(xc, w, b, padding=d * (k - 1) // 2, dilation=d))
    n = sum(lens)
    ops = 2 * k * C * C * n
    nbytes = 4 * (n * C + k * C * C + C + B * T * C + (n * C if res is not None else 0))
    row = {"ms": ms, "plain_ms": plain, **least_time(nbytes, ops, F32_FLOP_S), "library_ms": lib}
    log(f"[k4] T={T} k={k} d={d} launch={k4.launch_shape(B, T, C)}: kernel={ms:.4f}ms "
        f"plain={plain:.4f}ms F.conv1d={lib:.4f}ms bound={row['bound_ms']:.4f}ms "
        f"({row['bound_by']}), {ops / (ms * 1e-3) / F32_FLOP_S:.1%} of the f32 peak")
    return row


def check_k4(dev, gen) -> dict:
    C, worst, worst_ratio, at, short = VOCODER_CH, 0.0, 0.0, {}, {}
    # the vocoder's shapes, then the short route's: stage 1 of a 40-code
    # request (640 rows), where every resblock conv is a K4 launch
    cases = [(shape, ((7, 1), (3, 1), (3, 3), (3, 5))) for shape in VOC_SHAPES]
    cases.append(((1, 640, [640]), ((3, 1), (3, 3), (3, 5))))
    for (B, T, lens), kds in cases:
        x, L = voc_inputs(dev, gen, B, T, lens)
        for k, d in kds:
            w = (torch.randn(C, C, k, generator=gen) * 0.05).to(dev)
            b = (torch.randn(C, generator=gen) * 0.02).to(dev)
            res = x if k == 3 else None  # conv2 of a resblock layer; the noise conv has none
            err, ratio = k4_case(x, L, lens, w, b, d, res)
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
            if (T, k, d) == (491520, 7, 1):  # the last stage's noise conv
                at = {**k4_timing(x, L, lens, w, b, d, res),
                      "at": f"B=1 T={T} (length {lens[0]}) C={C} k=7 d=1; "
                      f"library = F.conv1d on [1, {C}, {T}]"}
            elif (T, k, d) == (640, 3, 1):  # a short-route resblock conv
                short = {**k4_timing(x, L, lens, w, b, d, res),
                         "at": f"B=1 T={T} C={C} k=3 d=1 with residual; library = "
                         f"F.conv1d on [1, {C}, {T}], no residual"}
        del x
    return {"max_abs_err": worst, "err_over_bound": worst_ratio, **at, "short_route": short}


def check_k5(dev, gen) -> dict:
    C, worst, at = VOCODER_CH, 0.0, {}
    for B, T, lens in VOC_SHAPES:
        x, L = voc_inputs(dev, gen, B, T, lens)
        a = voc_act(dev, gen)
        args = (x, L, a["up_filter"], a["alpha"], a["beta"], a["down_filter"])
        got = k5.activation1d(*args)
        torch.cuda.synchronize()
        ref = k5.activation1d_plain(*args)
        err = (got - ref).abs()
        if not bool((err <= K5_ATOL + K5_RTOL * ref.abs()).all()):
            raise AssertionError(f"K5 B={B} T={T}: error {err.max().item()} exceeds "
                                 f"{K5_ATOL} + {K5_RTOL} |ref|")
        worst = max(worst, err.max().item())
        log(f"[k5] B={B} T={T} C={C} taps 12/12 lengths={lens}: max_abs_err={err.max().item():.3e}")
        if T == 491520:
            ms = cuda_ms(lambda: k5.activation1d(*args))
            plain = cuda_ms(lambda: k5.activation1d_plain(*args))
            n, k1_, k2_ = sum(lens), a["up_filter"].shape[0], a["down_filter"].shape[0]
            # two 2x samples an output, each a k1/2-tap FMA FIR and a 12-op
            # snake (sin, cos, division one op each), then a k2-tap FMA FIR
            ops = (2 * (k1_ + 12) + 2 * k2_) * n * C
            nbytes = 4 * (n * C + B * T * C + k1_ + k2_ + 2 * C)
            at = {"ms": ms, "plain_ms": plain, **least_time(nbytes, ops, F32_FLOP_S),
                  "library_ms": None, "at": f"B=1 T={T} (length {lens[0]}) C={C}"}
            log(f"[k5] T={T}: kernel={ms:.4f}ms plain={plain:.4f}ms "
                f"bound={at['bound_ms']:.4f}ms ({at['bound_by']})")
        del x
    return {"max_abs_err": worst, **at}


def k6_bound(B: int, T: int, n: int) -> dict:
    """K6's least time over n valid rows of [B, T, 128]: two k=3 C x C convs
    and two activations (counted as in check_k5) at the f32 peak, or x in
    and y out with the weights once."""
    C = VOCODER_CH
    ops = 2 * (2 * 3 * C * C) * n + 2 * (2 * (12 + 12) + 2 * 12) * n * C
    nbytes = 4 * (n * C + B * T * C + 2 * (3 * C * C + C) + 4 * 12 + 4 * C)
    return least_time(nbytes, ops, F32_FLOP_S)


def check_k6(dev, gen) -> dict:
    C, worst, at = VOCODER_CH, 0.0, {}
    actA, actB = voc_act(dev, gen), voc_act(dev, gen)
    w1, w2 = ((torch.randn(C, C, 3, generator=gen) * 0.05).to(dev) for _ in range(2))
    b1, b2 = ((torch.randn(C, generator=gen) * 0.02).to(dev) for _ in range(2))
    for B, T, lens in VOC_SHAPES:
        x, L = voc_inputs(dev, gen, B, T, lens)
        for d in (1, 3, 5):
            args = (x, L, actA, w1, b1, d, actB, w2, b2)
            got = k6.resblock_layer(*args)
            torch.cuda.synchronize()
            err = (got - k6.resblock_layer_plain(*args)).abs().max().item()
            log(f"[k6] B={B} T={T} C={C} d={d} lengths={lens} "
                f"launch={tuple(k6.launch_shape(B, T, C, 3, d, 3))}: max_abs_err={err:.3e}")
            if not err <= K6_TOL:
                raise AssertionError(f"K6 error {err} > {K6_TOL} at B={B} T={T} d={d}")
            worst = max(worst, err)
            if T == 491520 and d == 5:
                ms = cuda_ms(lambda: k6.resblock_layer(*args))
                plain = cuda_ms(lambda: k6.resblock_layer_plain(*args))
                at = {"ms": ms, "plain_ms": plain, **k6_bound(B, T, sum(lens)),
                      "library_ms": None, "at": f"B=1 T={T} (length {lens[0]}) C={C} d=5"}
                log(f"[k6] T={T} d=5: kernel={ms:.4f}ms plain={plain:.4f}ms "
                    f"bound={at['bound_ms']:.4f}ms ({at['bound_by']})")
        if T != 491520:  # the padded-bucket invariant: bit-equal valid rows, zeros beyond
            y1 = k6.resblock_layer(x, L, actA, w1, b1, 3, actB, w2, b2)
            y2 = k6.resblock_layer(F.pad(x, (0, 0, 0, 480)), L, actA, w1, b1, 3, actB, w2, b2)
            if not (torch.equal(y2[:, :T], y1) and bool((y2[:, T:] == 0).all())):
                raise AssertionError(f"K6 B={B} T={T}: a bucket 480 rows longer changed the result")
            log(f"[k6] B={B} T={T} vs T={T + 480}: valid rows bit-equal, padding zero")
        del x
    # the kernel's other plans at a ragged pair: a k=11 conv (BigVGAN's
    # widest resblock kernel; the small tile) and 16/20-tap filters (the
    # generic activation template)
    x, L = voc_inputs(dev, gen, 2, 2560, [2560, 1777])
    wide = [(torch.randn(C, C, 11, generator=gen) * 0.02).to(dev) for _ in range(2)]
    f16 = voc_act(dev, gen)
    f16["up_filter"] = torch.hann_window(18, periodic=False, device=dev)[1:-1] / 8.0
    f16["down_filter"] = torch.hann_window(22, periodic=False, device=dev)[1:-1] / 10.0
    for name, args in (("k=11 d=5", (x, L, actA, wide[0], b1, 5, actB, wide[1], b2)),
                       ("taps 16/20 d=3", (x, L, f16, w1, b1, 3, f16, w2, b2))):
        got = k6.resblock_layer(*args)
        torch.cuda.synchronize()
        err = (got - k6.resblock_layer_plain(*args)).abs().max().item()
        k, taps = args[3].shape[-1], (args[2]["up_filter"].shape[0], args[2]["down_filter"].shape[0])
        log(f"[k6] B=2 T=2560 {name} launch={tuple(k6.launch_shape(2, 2560, C, k, args[5], k, taps, taps))}: "
            f"max_abs_err={err:.3e}")
        if not err <= K6_TOL:
            raise AssertionError(f"K6 error {err} > {K6_TOL} at {name}")
        worst = max(worst, err)
    del x
    # the five vocoder stages of a 400-code request (9 layers each), at d=5
    by_stage, req_ms, req_bound = {}, 0.0, 0.0
    for T, n in K6_STAGES:
        x, L = voc_inputs(dev, gen, 1, T, [n])
        args = (x, L, actA, w1, b1, 5, actB, w2, b2)
        ms = cuda_ms(lambda: k6.resblock_layer(*args), iters=10)
        lb = k6_bound(1, T, n)
        by_stage[f"T={T} length {n}"] = [round(ms, 5), round(lb["bound_ms"], 5)]
        req_ms, req_bound = req_ms + 9 * ms, req_bound + 9 * lb["bound_ms"]
        log(f"[k6] stage T={T} length {n} d=5 launch={tuple(k6.launch_shape(1, T, C, 3, 5, 3))}: "
            f"kernel={ms:.4f}ms bound={lb['bound_ms']:.4f}ms ({lb['bound_by']})")
        del x
    log(f"[k6] a 400-code request's 45 layers at d=5: {req_ms:.2f}ms against a {req_bound:.2f}ms "
        f"bound (loss {req_ms - req_bound:.2f}ms)")
    # per stage: [kernel, bound] ms
    return {"max_abs_err": worst, **at, "by_stage_ms": by_stage,
            "request_ms": req_ms, "request_bound_ms": req_bound}


def parse_wav(path: Path) -> tuple[int, np.ndarray]:
    data = path.read_bytes()
    riff, size, wave, fmt, _, pcm, ch, sr, _, _, bits, tag, n = struct.unpack_from(
        "<4sI4s4sIHHIIHH4sI", data)
    if (riff, wave, fmt, tag, pcm, ch, bits) != (b"RIFF", b"WAVE", b"fmt ", b"data", 1, 1, 16):
        raise AssertionError(f"{path}: not a mono 16-bit PCM WAV")
    if size != 36 + n or len(data) != 44 + n:
        raise AssertionError(f"{path}: RIFF sizes do not match the file")
    return sr, np.frombuffer(data[44:], "<i2")


def drive_cli(name: str, tmp: Path, argv: list[str], kernels) -> tuple[str, int, int, np.ndarray,
                                                                        dict]:
    """One run of ``cli.main(argv)`` that also writes its WAV and its codes
    under ``tmp``. Every module in ``kernels`` must launch its kernel, and no
    other module may. Returns (stderr, n_codes, sample rate, pcm, launches
    by module)."""
    wav, codes_out = tmp / f"{name}.wav", tmp / f"{name}.codes"
    before = {m: m.launches for m in MODS}
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main([*argv, "-emb", str(tmp / "voice.emb.gguf"), "--tts-mio-codes-out",
                       str(codes_out), "-o", str(wav)])
    text = err.getvalue()
    if rc != 0:
        raise AssertionError(f"{name}: cli exited {rc}:\n{text}")
    sr, pcm = parse_wav(wav)
    if not np.any(pcm != 0):
        raise AssertionError(f"{name}: the WAV is silent")
    grew = {m: m.launches - b for m, b in before.items()}
    for m, g in grew.items():
        if (m in kernels) != (g > 0):
            raise AssertionError(f"{name}: {m.__name__} launches grew by {g}")
    return text, len(codes_out.read_text().split()), sr, pcm, grew


def launch_text(grew: dict) -> str:
    return " ".join(f"{m.__name__.rsplit('.', 1)[-1]}={g}" for m, g in grew.items())


def run_request(i: str, tmp: Path, prompt: str, n_predict: int, extra: list[str], ccfg,
                model: str = "llm.gguf", kernels=(k1, k2)) -> dict:
    """One text -> WAV run through the CLI on the wave codec; the WAV has the
    sample count its codes imply (the iSTFT's)."""
    text, n_codes, sr, pcm, grew = drive_cli(
        f"req{i}", tmp, ["-mv", str(tmp / "codec.gguf"), "-m", str(tmp / model), "-p", prompt,
                         "-n", str(n_predict), *extra], kernels)
    frames = ccfg.stft_frames(n_codes)
    n_pad = (ccfg.n_fft - ccfg.hop_length) // 2
    want = (frames - 1) * ccfg.hop_length + ccfg.n_fft - 2 * n_pad
    if pcm.size != want:
        raise AssertionError(f"request {i}: {pcm.size} samples, {n_codes} codes imply {want}")
    tok_s = float(re.search(r"tok/s=([0-9.]+)", text).group(1))
    n_tok = int(re.search(r"n_tokens=(\d+)", text).group(1))
    codec_ms = float(re.search(r"synth breakdown: decode=([0-9.]+)ms", text).group(1))
    log(f"[request {i}] {model} prompt_chars={len(prompt)} n_predict={n_predict} "
        f"{' '.join(extra)}: tokens={n_tok} tok/s={tok_s} codes={n_codes} codec_ms={codec_ms} "
        f"audio_s={pcm.size / sr} launches: {launch_text(grew)}")
    return {"tokens": n_tok, "tok_s": tok_s, "codec_ms": codec_ms, "audio_s": pcm.size / sr}


def vocoder_launches(mcfg, bucket: int) -> dict:
    """K4/K5/K6 launches of one mel decode of a ``bucket``-code batch by the
    vocoder's dispatch rules (models/vocoder.py): per stage one K4 (noise
    conv), then each resblock layer is one K6 at >= 1024 padded rows, else
    K5, K4, K5, K4; one K5 after the last stage."""
    n = {k4: 0, k5: 0, k6: 0}
    rows, layers = mcfg.decoder_frames(bucket), 3 * mcfg.vocoder_num_kernels
    for rate in mcfg.vocoder_upsample_rates:
        rows *= rate
        n[k4] += 1
        if rows >= 1024:
            n[k6] += layers
        else:
            n[k5] += 2 * layers
            n[k4] += 2 * layers
    n[k5] += 1
    return n


def mel_request(name: str, tmp: Path, mcfg, extra: list[str], kernels) -> dict:
    """One mel-mode run (codes or text -> WAV) through the CLI on the mel
    codec. The WAV has the vocoder's sample count and is not clipped; K4-K6
    launched exactly as the vocoder's dispatch rules say for the bucket."""
    t0 = time.perf_counter()
    text, n_codes, sr, pcm, grew = drive_cli(
        f"mel-{name}", tmp, ["-mv", str(tmp / "mel_codec.gguf"),
                             *[str(tmp / a) if a.endswith((".gguf", ".txt")) else a
                               for a in extra]], kernels)
    wall_s = time.perf_counter() - t0
    want = mcfg.stft_frames(n_codes) * math.prod(mcfg.vocoder_upsample_rates)
    if sr != mcfg.sample_rate or pcm.size != want:
        raise AssertionError(f"mel request {name}: {pcm.size} samples at {sr} Hz, "
                             f"{n_codes} codes imply {want} at {mcfg.sample_rate}")
    clipped = float(np.mean(np.abs(pcm.astype(np.int32)) >= 32767))
    if clipped > MEL_CLIPPED_MAX:
        raise AssertionError(f"mel request {name}: {clipped:.3f} of the samples clip")
    expect = vocoder_launches(mcfg, pick_bucket(n_codes))
    if any(grew[m] != n for m, n in expect.items()):
        raise AssertionError(f"mel request {name}: K4/K5/K6 launched {[grew[m] for m in expect]}, "
                             f"dispatch implies {list(expect.values())}")
    codec_ms = float(re.search(r"synth breakdown: decode=([0-9.]+)ms", text).group(1))
    tok = re.search(r"tok/s=([0-9.]+)", text)
    log(f"[mel {name}] codes={n_codes} bucket={pick_bucket(n_codes)} codec_ms={codec_ms} "
        f"wall_s={wall_s:.2f} audio_s={pcm.size / sr} peak={np.abs(pcm).max() / 32767:.3f}"
        + (f" tok/s={tok.group(1)}" if tok else "") + f" launches: {launch_text(grew)}")
    return {"codec_ms": codec_ms, "audio_s": pcm.size / sr}


def fidelity(path: Path, device, codes, emb, sample_rate: int, what: str) -> None:
    """The same codes decoded on the card and on the CPU (plain versions,
    f32): finite, the same length, mel-L1 < MEL_L1_MAX."""
    outs = []
    for d in (device, torch.device("cpu")):
        res = MioTTSPipeline(path, d).synthesize(codes, emb)
        outs.append(res.audio)
        log(f"[fidelity {what}] {d.type}: {res.audio.size} samples in {res.decode_ms:.1f}ms")
    if outs[0].shape != outs[1].shape or not np.all(np.isfinite(outs[0])):
        raise AssertionError(f"{what}: card and CPU decodes differ in shape or are not finite")
    l1 = mel_l1(outs[0], outs[1], sample_rate)
    diff = float(np.abs(outs[0] - outs[1]).max())
    log(f"[fidelity {what}] mel-L1(card, CPU f32) = {l1:.3e}, max abs diff = {diff:.3e}")
    if not l1 < MEL_L1_MAX:
        raise AssertionError(f"{what}: mel-L1 {l1} >= {MEL_L1_MAX}")


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
    t0 = time.perf_counter()
    results = {k1: check_k1(dev, gen), k2: check_k2(dev, gen), k3: check_k3(dev, gen)}
    log(f"[checks] K1-K3 in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    results.update({k4: check_k4(dev, gen), k5: check_k5(dev, gen), k6: check_k6(dev, gen)})
    log(f"[checks] K4-K6 in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="miotts_chip_smoke_") as d:
        tmp = Path(d)
        t0 = time.perf_counter()
        ccfg = full_codec_config()
        write_synthetic_miocodec_gguf(str(tmp / "codec.gguf"), ccfg, seed=0,
                                      with_global_encoder=False)
        write_synthetic_llm_gguf(str(tmp / "llm.gguf"), **LLM_WIDTHS)
        write_synthetic_llm_gguf(str(tmp / "llm_q8_0.gguf"), quant="q8_0", **LLM_WIDTHS)
        mcfg = full_mel_codec_config()
        write_synthetic_mel_vocoder_gguf(str(tmp / "mel_codec.gguf"), mcfg, seed=0, ch=VOCODER_CH)
        tame_vocoder_weights(tmp / "mel_codec.gguf")
        rng = np.random.RandomState(0)
        emb = rng.randn(ccfg.decoder_adanorm_dim).astype(np.float32)
        save_embedding_gguf(tmp / "voice.emb.gguf", emb)
        for n in (40, 400):
            (tmp / f"codes{n}.txt").write_text(
                "\n".join(map(str, rng.randint(0, mcfg.vocab_size, n))))
        log(f"[assets] wave and mel codecs + 0.1B llm (f32, Q8_0) + embedding written in "
            f"{time.perf_counter() - t0:.1f}s")

        # each path is driven with every count at 0 and read right after
        launches = {}
        for path, reqs in (("bf16", [(*r, (k1, k2)) for r in REQUESTS]),
                           ("quant", QUANT_REQUESTS), ("mel", MEL_REQUESTS)):
            for m in MODS:
                m.launches = 0
            t0 = time.perf_counter()
            if path == "mel":
                for name, extra, kernels in reqs:
                    mel_request(name, tmp, mcfg, extra, kernels)
            else:
                for i, (prompt, n_predict, extra, kernels) in enumerate(reqs):
                    run_request(f"{path}-{i}", tmp, prompt, n_predict, extra, ccfg,
                                "llm.gguf" if path == "bf16" else "llm_q8_0.gguf", kernels)
            launches[path] = {m: m.launches for m in MODS}
            log(f"[{path} path] {time.perf_counter() - t0:.1f}s, launches: "
                f"{launch_text(launches[path])}")

        fidelity(tmp / "codec.gguf", dev, rng.randint(0, ccfg.vocab_size, 250), emb,
                 ccfg.sample_rate, "wave")
        fidelity(tmp / "mel_codec.gguf", dev, rng.randint(0, mcfg.vocab_size, 64), emb,
                 mcfg.sample_rate, "mel")

    if any(m == "jax" or m.startswith(("jax.", "miotts_tpu.")) or m == "miotts_tpu"
           for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    kernels = []
    for name, mod in (("banded_attention", k1), ("decode_attention", k2), ("q8_matmul", k3),
                      ("conv1d_same", k4), ("activation1d", k5), ("resblock_layer", k6)):
        by_path = {path: n[mod] for path, n in launches.items()}
        kernels.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                        "replaces": mod.REPLACES, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **results[mod]})
    log(f"[total] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
