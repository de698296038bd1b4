#!/usr/bin/env python3
"""Where a mel-mode codec decode of the PyTorch/CUDA port spends its time on
the card.

    python3 scripts/profile_torch_mel.py [--codes 400] [--runs 5] [--graph]

Writes the full-width synthetic mel codec (``testing.full_mel_codec_config``,
128-channel vocoder, ``testing.tame_vocoder_weights``) to a temporary
directory, pads ``--codes`` random codes into the pipeline's bucket and
decodes them on the card:

- the host wall time of the trunk (``codec_decode_spec``: prenet, resize,
  decoder transformer, mel head) and of the vocoder (``vocoder_decode``),
  each ended by ``torch.cuda.synchronize()``, over ``--runs`` runs after
  one warm-up run;
- one more decode under ``torch.profiler``: device time by kernel name, the
  device's busy time (the union of its kernel intervals) and its idle share
  of the wall time, for the trunk and the vocoder apart, and the launches
  and device time of kernels K1 (the trunk's attention), K4, K5 and K6.

With ``--graph`` it then does the same for the trunk and the vocoder each
captured as a CUDA graph (``models/codec_graph.py``; the vocoder graph reads
the trunk graph's output buffer) and replayed, with each capture's host
time and the replayed audio against the eager decode's.

Prints the card's name and power limit, then one JSON object as the last
line. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from miotts_tpu_torch.device import select_device  # noqa: E402
from miotts_tpu_torch.models.codec_graph import CodecGraph  # noqa: E402
from miotts_tpu_torch.models.miocodec import codec_decode_spec, load_miocodec  # noqa: E402
from miotts_tpu_torch.models.vocoder import vocoder_decode  # noqa: E402
from miotts_tpu_torch.ops.cuda import activation1d as k5  # noqa: E402
from miotts_tpu_torch.ops.cuda import banded_attention as k1  # noqa: E402
from miotts_tpu_torch.ops.cuda import build  # noqa: E402
from miotts_tpu_torch.ops.cuda import conv1d as k4  # noqa: E402
from miotts_tpu_torch.ops.cuda import resblock as k6  # noqa: E402
from miotts_tpu_torch.pipeline import pick_bucket  # noqa: E402
from miotts_tpu_torch.testing import (  # noqa: E402
    full_mel_codec_config, tame_vocoder_weights, write_synthetic_mel_vocoder_gguf)


def busy_ms(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (µs in, ms out)."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codes", type=int, default=400)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--graph", action="store_true",
                    help="also profile the trunk and the vocoder as CUDA graph replays")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_mel: needs a CUDA card", file=sys.stderr)
        return 2
    dev = select_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    build.load_library()
    with tempfile.TemporaryDirectory(prefix="miotts_profile_mel_") as d:
        path = Path(d) / "mel_codec.gguf"
        write_synthetic_mel_vocoder_gguf(str(path), full_mel_codec_config(), seed=0, ch=128)
        tame_vocoder_weights(path)
        cfg, w = load_miocodec(str(path), dev)

    rng = np.random.RandomState(0)
    bucket = pick_bucket(args.codes)
    tokens = np.zeros((1, bucket), np.int64)
    tokens[0, :args.codes] = rng.randint(0, cfg.vocab_size, args.codes)
    tok = torch.from_numpy(tokens).to(dev)
    lengths = torch.tensor([args.codes], dtype=torch.int32, device=dev)
    cond = torch.from_numpy(rng.randn(1, cfg.decoder_adanorm_dim).astype(np.float32)).to(dev)

    def decode() -> tuple[float, float, int]:
        t0 = time.perf_counter()
        with record_function("trunk"):
            spec, frames = codec_decode_spec(cfg, w, tok, lengths, cond, matmul="float32")
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        with record_function("vocoder"):
            _, n = vocoder_decode(cfg, w, spec, frames)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3, int(n[0])

    result = {"device": torch.cuda.get_device_name(0),
              "power_limit": smi.stdout.strip().split(", ")[-1], "codes": args.codes,
              "bucket": bucket, **profile_decode(decode, args.runs, cfg.sample_rate, "eager")}
    if args.graph:
        result["graph"] = profile_graph(cfg, w, tok, lengths, cond, args.runs)
    print(json.dumps(result))
    return 0


def profile_decode(decode, runs: int, sample_rate: int, label: str) -> dict:
    """``decode()`` once to warm up, ``runs`` timed runs, one profiled run:
    wall, device busy and idle of the trunk and the vocoder, K1 and K4-K6
    launches and device ms, the top kernels."""
    decode()
    timed = [decode() for _ in range(runs)]
    for m in (k1, k4, k5, k6):
        m.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trunk_wall, voc_wall, n_samples = decode()
    launches = {"banded_attention": k1.launches, "conv1d_same": k4.launches,
                "activation1d": k5.launches, "resblock_layer": k6.launches}

    events = prof.events()
    voc_start = min(e.time_range.start for e in events if e.name == "vocoder")
    # device events, less the device-side spans of the two record_function
    # ranges, which cover their parts whole and would read as busy
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in ("trunk", "vocoder")]
    by_name: dict[str, list[float]] = {}
    parts = {"trunk": [], "vocoder": []}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        parts["vocoder" if e.time_range.start >= voc_start else "trunk"].append(
            (e.time_range.start, e.time_range.end))
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
    # device time of each vocoder kernel, by the name of its CUDA function
    marks = {"banded_attention": "banded_attention_kernel", "conv1d_same": "conv1d_same_kernel",
             "activation1d": "activation1d_kernel", "resblock_layer": "resblock_kernel"}
    device_ms = {k: sum(t for name, ts in by_name.items() if m in name for t in ts) / 1e3
                 for k, m in marks.items()}
    walls = {"trunk": trunk_wall, "vocoder": voc_wall}
    result = {
        "audio_s": n_samples / sample_rate,
        "runs_ms": {"trunk": [round(r[0], 3) for r in timed],
                    "vocoder": [round(r[1], 3) for r in timed]},
        "profiled": {part: {"wall_ms": walls[part], "device_busy_ms": busy_ms(iv),
                            "idle_share": 1.0 - busy_ms(iv) / walls[part]}
                     for part, iv in parts.items()},
        "launches": launches, "kernel_device_ms": device_ms,
        "by_kernel_ms": [{"name": name[:90], "calls": len(t), "ms": sum(t) / 1e3}
                         for name, t in top],
    }
    print(f"{label}: runs trunk {result['runs_ms']['trunk']} ms, vocoder "
          f"{result['runs_ms']['vocoder']} ms", flush=True)
    for part, r in result["profiled"].items():
        print(f"{label} {part}: wall {r['wall_ms']:.2f} ms, device busy "
              f"{r['device_busy_ms']:.2f} ms, idle {r['idle_share']:.1%}", flush=True)
    print("  kernels: " + ", ".join(f"{k} {launches[k]}x {device_ms[k]:.3f} ms"
                                    for k in launches), flush=True)
    for k in result["by_kernel_ms"]:
        print(f"  {k['ms']:9.3f} ms {k['calls']:5d}x {k['name']}", flush=True)
    return result


def profile_graph(cfg, w, tok, lengths, cond, runs: int) -> dict:
    """The trunk and the vocoder as replays of two CUDA graphs (each with
    its own warm-up and memory pool; the vocoder graph's input is the trunk
    graph's output buffer), profiled as ``profile_decode`` does."""
    spec_ref, frames = codec_decode_spec(cfg, w, tok, lengths, cond, matmul="float32")
    audio_ref = vocoder_decode(cfg, w, spec_ref, frames)[0]
    stream = torch.cuda.Stream()
    trunk = CodecGraph(lambda i: codec_decode_spec(cfg, w, i["tokens"], i["lengths"], i["cond"],
                                                   matmul="float32")[0],
                       {"tokens": tok, "lengths": lengths, "cond": cond}, stream)
    trunk.replay()  # the vocoder graph's warm-up reads a real spec
    vocoder = CodecGraph(lambda i: vocoder_decode(cfg, w, i["spec"], i["frames"])[0],
                         {"spec": trunk.out, "frames": frames}, stream)

    def decode() -> tuple[float, float, int]:
        t0 = time.perf_counter()
        with record_function("trunk"):
            trunk.replay()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        with record_function("vocoder"):
            vocoder.replay()
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3, int(frames[0]) * math.prod(
            cfg.vocoder_upsample_rates)

    decode()
    diff = (vocoder.out - audio_ref).abs().max().item()
    print(f"graph: capture trunk {trunk.capture_ms:.1f} ms, vocoder {vocoder.capture_ms:.1f} ms "
          f"(warm-ups included); replayed audio vs eager: spec "
          f"{'bit-equal' if torch.equal(trunk.out, spec_ref) else 'differs'}, audio "
          f"{'bit-equal' if torch.equal(vocoder.out, audio_ref) else f'max abs diff {diff:.3e}'}",
          flush=True)
    return {"capture_ms": {"trunk": trunk.capture_ms, "vocoder": vocoder.capture_ms},
            "audio_max_abs_diff_vs_eager": diff,
            **profile_decode(decode, runs, cfg.sample_rate, "graph")}


if __name__ == "__main__":
    sys.exit(main())
