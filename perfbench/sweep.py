"""Find a cell's knee once: one set-up, then windows of the cell's traffic
at each rate, lowest first, each rate on ``--repeat`` seeds.

    python3 -m perfbench.sweep --workload NAME --seed N --seconds S --rates R1 R2 ... [--repeat K]

For each window it prints the requests, the failures, audio-s per s, the
latency median and 95th percentile, the TTFA median, 90th and 95th
percentiles, whether the backlog grew (``growth``: the median latency of
the requests due in the window's last third over that of its first third;
and the requests still unanswered when the window closed) and the check's
readings of what was served (``check.judge``). The knee is the highest
rate at which every window's latency median stays within KNEE_RATIO of the
lowest rate's, with no failure: below it the median grows only as the
batch's width slows each step; past it, requests wait for free slots and
the median of identical traffic swings from run to run.
The cell's file records it beside the rate the cell runs at. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

import torch

from perfbench import check, harness
from perfbench.stats import latencies_ms, percentile

KNEE_RATIO = 1.5


def growth(w) -> float | None:
    """Median latency of the last third's requests over the first third's."""
    thirds = [[], [], []]
    for r in w.requests:
        rec = w.records.get(r.i)
        lat = (rec["done"] - rec["due"]) if rec and rec.get("ok") else float("inf")
        thirds[min(2, int(3 * r.due_s / w.seconds))].append(lat)
    if not thirds[0] or not thirds[2]:
        return None
    return statistics.median(thirds[2]) / statistics.median(thirds[0])


def summary(w) -> dict:
    lat = latencies_ms(w)
    ttfa = latencies_ms(w, True, True)
    n = sum(k for r in w.records.values() for t, k in r.get("audio_events", [])
            if 0.0 <= t <= w.seconds)
    return {"requests": w.attempted, "failed": w.attempted - len(w.ok),
            "audio_s_per_s": n / w.sample_rate / w.seconds,
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "ttfa_p50_ms": percentile(ttfa, 50), "ttfa_p90_ms": percentile(ttfa, 90),
            "ttfa_p95_ms": percentile(ttfa, 95),
            "growth": growth(w),
            "unanswered_at_close": sum(1 for r in w.records.values()
                                       if not r.get("ok") or r["done"] > w.seconds),
            "late_ms_max": w.loadgen.get("late_ms_max")}


def knee(rows: list[dict]) -> float | None:
    """The highest rate whose every window keeps its latency median within
    KNEE_RATIO of the lowest rate's median, with no failure."""
    rates = sorted({r["rate_rps"] for r in rows})
    base = [r["p50_ms"] for r in rows if r["rate_rps"] == rates[0] and r["p50_ms"]]
    if not base:
        return None
    limit = KNEE_RATIO * statistics.median(base)
    out = None
    for rate in rates:
        at = [r for r in rows if r["rate_rps"] == rate]
        if any(r["failed"] or r["p50_ms"] is None or r["p50_ms"] > limit for r in at):
            break
        out = rate
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.sweep: needs a CUDA card", file=sys.stderr)
        return 2
    from miotts_tpu_torch.device import select_device

    dev = select_device("cuda")
    bench = harness.Bench(args.workload)
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-sweep-"))
    rows = []
    try:
        bench.setup(tmp, args.seed, dev)
        judge = check.Judge(bench.paths, dev)
        k = 0
        for rate in sorted(args.rates):
            for _ in range(args.repeat):
                k += 1
                seed = args.seed + k
                reqs = bench.schedule(seed, args.seconds, rate)
                smp = bench.sample(reqs, seed)
                w = bench.window(reqs, args.seconds, keep=set(smp["wav"]) | set(smp["stream"]))
                r = check.judge(judge, {q.i: q for q in reqs}, w.records, smp,
                                tmp / f"window{bench.n_windows}" / "keep")
                rows.append({"rate_rps": rate, "seed": seed, **summary(w), "check": r})
                print(json.dumps(rows[-1]), flush=True)
    finally:
        bench.close()
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"workload": args.workload, "knee_rps": knee(rows),
                      "knee_ratio": KNEE_RATIO, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
