#!/usr/bin/env python3
"""Where one LLM decode step of the PyTorch/CUDA port spends its time on the
card, and what kernels K2 (decode attention) and K3 (Q8_0 matmul) take of it.

    python3 scripts/profile_torch_decode.py [--steps 64] [--prompt 32] [--cache 700]
                                            [--llm-quant q8_0]

Writes the full-width synthetic 0.1B LLM (``chip_smoke.LLM_WIDTHS``: qwen2,
dim 768, 12 layers, 12 heads, 2 KV heads) to a temporary directory, loads
it dense in bf16 or, with ``--llm-quant MODE``, stored as Q8_0 and loaded by
the ``--llm-quant`` ladder (``q8_0``: every matmul on K3), prefills one
random ``--prompt``-token lane into a ``--cache``-row KV cache (the CLI
allocates max(700, T + n_predict + 32) rows) and runs decode steps on
greedy tokens, without the sampler:

- the host wall time of each of ``--steps`` steps, each ended by
  ``torch.cuda.synchronize()`` (the CLI's loop syncs once a token), after
  eight warm-up steps;
- ``--steps`` more steps under ``torch.profiler``: device time by kernel
  name, the device's busy time (the union of its kernel intervals) and its
  idle share of the wall time, and K2's and K3's time per launch, launches
  per step and share of the device time (K3's launches include any second
  pass it makes, such as a split-K sum).

Prints the card's name and power limit, then one JSON object as the last
line. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import LLM_WIDTHS  # noqa: E402
from miotts_tpu_torch.device import select_device  # noqa: E402
from miotts_tpu_torch.models.llm import (  # noqa: E402
    init_kv_cache, llm_decode_step, llm_prefill, load_llm_gguf)
from miotts_tpu_torch.ops.cuda import build  # noqa: E402
from miotts_tpu_torch.ops.cuda import decode_attention as k2  # noqa: E402
from miotts_tpu_torch.ops.cuda import q8_matmul as k3  # noqa: E402
from miotts_tpu_torch.testing import write_synthetic_llm_gguf  # noqa: E402
from scripts.profile_torch_mel import busy_ms  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--cache", type=int, default=700)
    ap.add_argument("--llm-quant", default="", help="a --llm-quant mode (default: dense bf16)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_decode: needs a CUDA card", file=sys.stderr)
        return 2
    dev = select_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    build.load_library()
    with tempfile.TemporaryDirectory(prefix="miotts_profile_decode_") as d:
        path = str(Path(d) / "llm.gguf")
        quant = args.llm_quant
        write_synthetic_llm_gguf(path, quant="q8_0" if quant else "f32", **LLM_WIDTHS)
        cfg, w, _ = load_llm_gguf(path, dev, torch.bfloat16, quantize=quant or "bf16")

    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, 1000, (1, args.prompt))).to(dev)
    lengths = torch.tensor([args.prompt], dtype=torch.int32, device=dev)
    ck, cv = init_kv_cache(cfg, 1, args.cache, dev)
    tok = llm_prefill(cfg, w, tokens, lengths, ck, cv).argmax(-1)
    pos = lengths.clone()

    def step() -> None:
        nonlocal tok
        tok = llm_decode_step(cfg, w, tok, pos, ck, cv).argmax(-1)
        pos.add_(1)
        torch.cuda.synchronize()

    for _ in range(8):
        step()
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    pos0 = int(pos[0])
    k2.launches = k3.launches = 0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
    wall = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])

    def per_kernel(mod, marks: tuple[str, ...]) -> dict:
        us = [t for name, ts in by_name.items() if any(m in name for m in marks) for t in ts]
        return {"launches": mod.launches, "launches_per_step": mod.launches / args.steps,
                "device_launches_per_step": len(us) / args.steps,
                "us_per_launch": sum(us) / max(1, len(us)),
                "ms_per_step": sum(us) / 1e3 / args.steps, "share_of_device": sum(us) / 1e3 / busy}

    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    result = {
        "device": torch.cuda.get_device_name(0), "power_limit": smi.stdout.strip().split(", ")[-1],
        "llm_quant": args.llm_quant or "bf16", "cache_rows": args.cache, "prompt": args.prompt,
        "steps": args.steps,
        "pos_range": [pos0, pos0 + args.steps - 1],
        "host_ms_per_step": {"median": statistics.median(walls), "min": min(walls),
                             "max": max(walls)},
        "profiled": {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
                     "device_ms_per_step": busy / args.steps},
        "k2": per_kernel(k2, ("decode_attention_kernel",)),
        "k3": per_kernel(k3, ("q8_matmul", "q8_gemv", "sum_splits")),
        "by_kernel_ms": [{"name": name[:90], "calls": len(t), "ms": sum(t) / 1e3}
                         for name, t in top],
    }
    p = result["profiled"]
    print(f"{result['llm_quant']} decode steps at pos {pos0}-{pos0 + args.steps - 1}: host "
          f"{result['host_ms_per_step']['median']:.3f} ms/step (median), device busy "
          f"{p['device_ms_per_step']:.3f} ms/step, idle {p['idle_share']:.1%}", flush=True)
    for name in ("k2", "k3"):
        k = result[name]
        print(f"  {name.upper()}: {k['device_launches_per_step']:.1f} device launches/step "
              f"({k['launches_per_step']:.1f} wrapper calls), {k['us_per_launch']:.2f} us/launch, "
              f"{k['ms_per_step']:.4f} ms/step, {k['share_of_device']:.1%} of device time",
              flush=True)
    for k in result["by_kernel_ms"]:
        print(f"  {k['ms']:9.3f} ms {k['calls']:5d}x {k['name']}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
