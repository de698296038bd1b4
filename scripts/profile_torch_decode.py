#!/usr/bin/env python3
"""Where one LLM decode step of the PyTorch/CUDA port spends its time on the
card, and what kernels K2 (decode attention) and K3 (Q8_0 matmul) take of it.

    python3 scripts/profile_torch_decode.py [--steps 64] [--prompt 32] [--cache 700]
                                            [--llm-quant q8_0] [--graph]
    python3 scripts/profile_torch_decode.py --served 4 [--prompt 142] [--cache 1024]

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
  idle share of the profiled wall time (the profiler slows the host) and of
  the unprofiled host time, and K2's and K3's time per launch, launches
  per step and share of the device time (K3's launches include any second
  pass it makes, such as a split-K sum).

With ``--graph`` it then does the same for chunks of ``llm.CHUNK`` steps of
the generation loop (``llm_start`` / ``fetch_chunk_result``, the CLI's
default sampler, no EOG so every chunk runs whole) on one ``llm.chunk``,
once as eager runs of its body (``Chunk.run_eager``) and once as replays
of its CUDA graph (``Chunk.run``): host ms a step (each
chunk ended by its one host read), device busy ms a step and idle share
under the profiler, CUDA-event ms a chunk, the capture's host time, and
K2's and K3's launches and time a step.

With ``--served W`` it profiles the server's decode instead: an 8-lane
batched state over ``--cache`` rows (``-np 8 --ctx-size``), W lanes
prefilled and attached (the cell's sampler, temp 0.8 top-k 50), and the
width-W graph of the batcher's largest rung (``SERVED_STEPS`` steps,
``llm.chunk`` with the lane list; the full width at W = 8): device kernels
a step and device busy ms a step from one profiled replay, CUDA-event ms
a replay (median of 5), and the fused kernels' launches a replay where the
package has them (``ops/cuda/llm_fused.py``, K7-K10; ``ops/cuda/llm_gemv.py``,
K11). Then the step's sampler
and bookkeeping alone, as the chunk body runs them on the W lanes' logits:
``llm_fused.sample_step`` (K10) where the package has it, else the inline
chain the chunk body ran before it (``sample_token_batched`` and its
bookkeeping, copied here), SERVED_STEPS steps captured in one graph and
replayed once under the profiler: its device kernels and busy ms a step,
and the rest of the step (the whole less the sampler).

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
    CHUNK, chunk, fetch_chunk_result, init_kv_cache, llm_decode_step, llm_prefill, llm_start,
    load_llm_gguf)
from miotts_tpu_torch.models.sampling import SamplerParams, sampler_key  # noqa: E402
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
    ap.add_argument("--graph", action="store_true",
                    help="also profile chunks of the generation loop, eager and as a CUDA graph")
    ap.add_argument("--served", type=int, default=0, metavar="W",
                    help="profile the server's width-W chunk graph instead (1, 2, 4 or 8)")
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
    if args.served:
        result = profile_served(args, cfg, w, dev)
        result.update(device=torch.cuda.get_device_name(0),
                      power_limit=smi.stdout.strip().split(", ")[-1])
        print(json.dumps(result))
        return 0

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()  # the profiler's own start and stop stay outside
        for _ in range(args.steps):
            step()
        wall = (time.perf_counter() - t0) * 1e3

    by_name, busy = device_kernels(prof)

    def per_kernel(mod, marks: tuple[str, ...]) -> dict:
        return kernel_share(by_name, busy, mod, marks, args.steps)

    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    result = {
        "device": torch.cuda.get_device_name(0), "power_limit": smi.stdout.strip().split(", ")[-1],
        "llm_quant": args.llm_quant or "bf16", "cache_rows": args.cache, "prompt": args.prompt,
        "steps": args.steps,
        "pos_range": [pos0, pos0 + args.steps - 1],
        "host_ms_per_step": {"median": statistics.median(walls), "min": min(walls),
                             "max": max(walls)},
        "profiled": {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
                     "device_ms_per_step": busy / args.steps,
                     "idle_share_unprofiled": 1.0 - busy / args.steps / statistics.median(walls)},
        "k2": per_kernel(k2, ("decode_attention_kernel",)),
        "k3": per_kernel(k3, ("q8_matmul", "q8_gemv", "sum_splits")),
        "by_kernel_ms": [{"name": name[:90], "calls": len(t), "ms": sum(t) / 1e3}
                         for name, t in top],
    }
    p = result["profiled"]
    print(f"{result['llm_quant']} decode steps at pos {pos0}-{pos0 + args.steps - 1}: host "
          f"{result['host_ms_per_step']['median']:.3f} ms/step (median), device busy "
          f"{p['device_ms_per_step']:.3f} ms/step, idle {p['idle_share']:.1%} profiled, "
          f"{p['idle_share_unprofiled']:.1%} of the unprofiled host time", flush=True)
    for name in ("k2", "k3"):
        k = result[name]
        print(f"  {name.upper()}: {k['device_launches_per_step']:.1f} device launches/step "
              f"({k['launches_per_step']:.1f} wrapper calls), {k['us_per_launch']:.2f} us/launch, "
              f"{k['ms_per_step']:.4f} ms/step, {k['share_of_device']:.1%} of device time",
              flush=True)
    for k in result["by_kernel_ms"]:
        print(f"  {k['ms']:9.3f} ms {k['calls']:5d}x {k['name']}", flush=True)
    if args.graph:
        result["chunks"] = {name: profile_chunks(args, cfg, w, tokens, lengths, dev, eager)
                            for name, eager in (("eager", True), ("graph", False))}
    print(json.dumps(result))
    return 0


def device_kernels(prof) -> tuple[dict[str, list[float]], float]:
    """Device kernels of a profile by name (µs each) and the device's busy ms."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return by_name, busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])


def kernel_share(by_name: dict, busy: float, mod, marks: tuple[str, ...], steps: int) -> dict:
    us = [t for name, ts in by_name.items() if any(m in name for m in marks) for t in ts]
    return {"launches": mod.launches, "launches_per_step": mod.launches / steps,
            "device_launches_per_step": len(us) / steps,
            "us_per_launch": sum(us) / max(1, len(us)),
            "ms_per_step": sum(us) / 1e3 / steps, "share_of_device": sum(us) / 1e3 / max(busy, 1e-9)}


SERVED_LANES = 8  # -np 8
SERVED_STEPS = 64  # the batcher's largest rung (its chunk_max)


def profile_served(args, cfg, w, dev) -> dict:
    """One replay of the server's width-``args.served`` chunk graph of
    SERVED_STEPS steps over an 8-lane state, ``args.served`` lanes live:
    device kernels and busy ms a step under the profiler, event ms a
    replay, the fused kernels' launches a replay (where they exist)."""
    from miotts_tpu_torch.models import llm
    from miotts_tpu_torch.models.sampling import BatchSamplerParams

    width, n = args.served, SERVED_LANES
    rng = np.random.RandomState(1)
    st = llm.init_batched_state(cfg, n, args.cache, dev)
    tokens = torch.from_numpy(rng.randint(0, 1000, (width, args.prompt))).to(dev)
    lengths = np.full(width, args.prompt, np.int32)
    logits, new_k, new_v = llm.llm_prefill_kv(cfg, w, tokens, torch.from_numpy(lengths).to(dev))
    llm.attach_lanes(st, np.arange(width), logits, new_k, new_v, lengths, np.arange(width) + 7)
    sampler = BatchSamplerParams.make([0.8] * n, [50] * n, [1.0] * n, [1.0] * n, dev)
    no_eog = torch.tensor([-1], dtype=torch.int64, device=dev)
    rem = torch.full((n,), 1 << 30, dtype=torch.int32, device=dev)
    lanes = torch.arange(width, dtype=torch.int64, device=dev) if width < n else None
    graph = llm.chunk(cfg, w, no_eog, SERVED_STEPS, sampler, st, rem=rem, lanes=lanes,
                      warm_state=lambda: llm.init_batched_state(cfg, n, args.cache, dev))
    pos0 = int(st.pos[0])
    events = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.run()
        end.record()
        torch.cuda.synchronize()
        events.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.run()
        torch.cuda.synchronize()
    by_name, busy = device_kernels(prof)
    kernels = sum(len(t) for t in by_name.values())
    fused = {getattr(k, "name", str(k)): c for k, c in graph.launches_per_replay.items()
             if not isinstance(k, tuple)
             and (".llm_fused." in getattr(k, "__name__", "")
                  or ".llm_gemv." in getattr(k, "__name__", ""))}
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    res = {"served_width": width, "lanes": n, "steps": SERVED_STEPS, "cache_rows": args.cache,
           "prompt": args.prompt,
           "pos_range": [pos0 + 5 * SERVED_STEPS, pos0 + 6 * SERVED_STEPS - 1],
           "device_kernels_per_step": kernels / SERVED_STEPS,
           "device_busy_ms_per_step": busy / SERVED_STEPS,
           "event_ms_per_replay": {"median": statistics.median(events), "min": min(events)},
           "fused_launches_per_replay": fused,
           "by_kernel_ms": [{"name": name[:90], "calls": len(t), "ms": sum(t) / 1e3}
                            for name, t in top]}
    print(f"served width {width} ({n} lanes, {args.cache} rows): "
          f"{res['device_kernels_per_step']:.1f} device kernels a step, busy "
          f"{res['device_busy_ms_per_step']:.4f} ms a step, events "
          f"{res['event_ms_per_replay']['median']:.3f} ms a {SERVED_STEPS}-step replay; fused "
          f"launches a replay {fused}", flush=True)
    for k in res["by_kernel_ms"]:
        print(f"  {k['ms']:9.3f} ms {k['calls']:5d}x {k['name']}", flush=True)
    idx = torch.arange(width, dtype=torch.int64, device=dev)
    samp = profile_sampler(st.logits.index_select(0, idx), sampler, st, idx, no_eog,
                           rem.index_select(0, idx), dev)
    res["sampler"] = samp
    res["rest"] = {"device_kernels_per_step": res["device_kernels_per_step"]
                   - samp["device_kernels_per_step"],
                   "device_busy_ms_per_step": res["device_busy_ms_per_step"]
                   - samp["device_busy_ms_per_step"]}
    print(f"sampler and bookkeeping alone ({samp['path']}): "
          f"{samp['device_kernels_per_step']:.1f} device kernels a step, busy "
          f"{samp['device_busy_ms_per_step'] * 1e3:.2f} us a step; the rest of the step "
          f"{res['rest']['device_kernels_per_step']:.1f} kernels, "
          f"{res['rest']['device_busy_ms_per_step'] * 1e3:.2f} us", flush=True)
    for k in samp["by_kernel_ms"]:
        print(f"  {k['ms']:9.3f} ms {k['calls']:5d}x {k['name']}", flush=True)
    return res


def profile_sampler(logits, sampler, st, idx, eog, rem, dev) -> dict:
    """SERVED_STEPS steps of the served step's sampler and bookkeeping on
    ``logits`` [W, V] (the lanes ``idx`` of ``st``), captured in one graph
    and replayed once under the profiler (one replay warms it up)."""
    from miotts_tpu_torch.models import sampling
    from miotts_tpu_torch.ops.cuda import llm_fused

    sub = sampling.BatchSamplerParams(*(t.index_select(0, idx) for t in
                                        (sampler.temp, sampler.top_k, sampler.top_p,
                                         sampler.repeat_penalty)))
    sstate = sampling.SamplerState(st.ring.index_select(0, idx), st.ring_idx.clone())
    key, pos = st.key.index_select(0, idx), st.pos.index_select(0, idx)
    done = st.done.index_select(0, idx)
    W = logits.shape[0]
    out = torch.zeros((W, SERVED_STEPS), dtype=torch.int64, device=dev)
    n_new = torch.zeros((W,), dtype=torch.int32, device=dev)
    step = getattr(llm_fused, "sample_step", None)

    def body():
        if step is not None:  # K10
            n_new.zero_()
            for s in range(SERVED_STEPS):
                _, adv = step(logits, sub, sstate, key, eog, rem, done, n_new, out[:, s])
                pos.add_(adv)
            return
        # the chunk body's inline chain before K10
        d = done
        count = torch.zeros_like(n_new)
        toks = []
        for _ in range(SERVED_STEPS):
            tok = sampling.sample_token_batched(logits, sub, sstate, key)
            key[:, 1].add_(1)
            sstate.update(tok)
            toks.append(torch.where(d, torch.zeros_like(tok), tok))
            count = count + (~d).to(count.dtype)
            d = d | (tok[:, None] == eog[None, :]).any(dim=-1) | (count >= rem)
            pos.add_((~d).to(torch.int32))
        done.copy_(d)
        out.copy_(torch.stack(toks, dim=1))
        n_new.copy_(count)

    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        body()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        body()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    by_name, busy = device_kernels(prof)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    return {"path": "K10" if step is not None else "inline chain",
            "device_kernels_per_step": sum(len(t) for t in by_name.values()) / SERVED_STEPS,
            "device_busy_ms_per_step": busy / SERVED_STEPS,
            "by_kernel_ms": [{"name": name[:90], "calls": len(t), "ms": sum(t) / 1e3}
                             for name, t in top]}


def profile_chunks(args, cfg, w, tokens, lengths, dev, eager: bool) -> dict:
    """Chunks of CHUNK steps from a fresh prefill, eager or as replays of
    a graph captured on that state: host ms a step, device busy and idle
    under the profiler, CUDA-event ms a chunk, K2 and K3 a step."""
    sampler = SamplerParams()  # the CLI's defaults: temp 0.8, top-k 50
    no_eog = torch.tensor([-1], dtype=torch.int64, device=dev)
    ck, cv = init_kv_cache(cfg, 1, args.cache, dev)
    state = llm_start(cfg, w, tokens, lengths, ck, cv, sampler_key(0, dev))
    n = CHUNK
    ch = chunk(cfg, w, no_eog, n, sampler, state)
    run, capture = (ch.run_eager, None) if eager else (ch.run, ch.capture_ms)
    fetch_chunk_result(*run(), state)
    n_chunks = max(1, args.steps // n)
    walls, events = [], []
    for _ in range(n_chunks):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = run()
        end.record()
        fetch_chunk_result(*out, state)
        walls.append((time.perf_counter() - t0) * 1e3 / n)
        events.append(start.elapsed_time(end))
    pos0 = int(state.pos[0])
    k2.launches = k3.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            fetch_chunk_result(*run(), state)
        wall = (time.perf_counter() - t0) * 1e3
    by_name, busy = device_kernels(prof)
    steps = n_chunks * n
    res = {"chunk": n, "chunks": n_chunks, "pos_range": [pos0, pos0 + steps - 1],
           "capture_ms": capture,
           "host_ms_per_step": {"median": statistics.median(walls), "min": min(walls),
                                "max": max(walls)},
           "event_ms_per_chunk": {"median": statistics.median(events), "min": min(events)},
           "profiled": {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
                        "device_ms_per_step": busy / steps,
                        "idle_share_unprofiled": 1.0 - busy / steps / statistics.median(walls),
                        "device_kernels": sum(len(t) for t in by_name.values())},
           "k2": kernel_share(by_name, busy, k2, ("decode_attention_kernel",), steps),
           "k3": kernel_share(by_name, busy, k3, ("q8_matmul", "q8_gemv", "sum_splits"), steps)}
    p = res["profiled"]
    print(f"{'eager' if eager else 'graph'} chunks of {n} (sampler temp 0.8 top-k 50) at pos "
          f"{pos0}-{pos0 + steps - 1}: host {res['host_ms_per_step']['median']:.3f} ms/step "
          f"(median), events {res['event_ms_per_chunk']['median'] / n:.3f} ms/step, device busy "
          f"{p['device_ms_per_step']:.3f} ms/step, idle {p['idle_share']:.1%} profiled, "
          f"{p['idle_share_unprofiled']:.1%} of the unprofiled host time"
          + ("" if eager else f", capture {capture:.1f} ms"), flush=True)
    for name in ("k2", "k3"):
        k = res[name]
        print(f"  {name.upper()}: {k['device_launches_per_step']:.1f} device launches/step "
              f"({k['launches_per_step']:.1f} counted), {k['us_per_launch']:.2f} us/launch, "
              f"{k['ms_per_step']:.4f} ms/step", flush=True)
    return res


if __name__ == "__main__":
    sys.exit(main())
