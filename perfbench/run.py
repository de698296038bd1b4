"""One run of one benchmark cell of the port (``miotts_tpu_torch``).

    python3 -m perfbench.run --workload NAME --seed N --seconds S --trace 0|1

Set-up (counted in ``setup_s``, from the process's start to the window's
opening): the weights from ``--seed``, the server from the cell's
configuration with its warm-up complete. Then one window of ``--seconds``
of the cell's open-loop traffic, every answer awaited; with ``--trace 1``
then a short slice of the same traffic at the same rate, a span inside it
profiled. After the window: the device's memory peak,
the server stopped, and the plain reference judging a sample of what was
served (``check.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``, each
number compared beside its limit (also the last lines of standard error).
Exits 2 without a CUDA card, or with fewer than the cell asks for, and 3
if JAX or the JAX package was loaded; neither prints a result.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a file: python3 perfbench/run.py
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    __package__ = "perfbench"

import torch  # noqa: E402

from perfbench import check, harness  # noqa: E402
from perfbench.trace import breakdown  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def finite(v):
    return v if v is not None and math.isfinite(v) else None


def run(args, device: torch.device, bench: harness.Bench, tmp: Path, faults=None) -> dict:
    """The run; ``faults`` (tests only) is called with the bench after its
    set-up to break the timed path."""
    from miotts_tpu_torch.device import select_device

    select_device(device.type)  # TF32 off for the program's matmuls and convs
    reqs = bench.schedule(args.seed, args.seconds)
    smp = bench.sample(reqs, args.seed)
    bench.setup(tmp, args.seed, device)
    if faults is not None:
        faults(bench)
    w = bench.window(reqs, args.seconds, keep=set(smp["wav"]) | set(smp["stream"]))
    kept = tmp / f"window{bench.n_windows}" / "keep"
    if args.trace:
        w.traced = bench.traced_slice(args.seed + 1)
    metrics = {}
    for m in (bench.per_layer if args.trace else bench.end_to_end):
        v = finite(harness.metric_reader(m["name"])(w))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "count": int(bench.cell["chips"]),
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                 if device.type == "cuda" else 0)}
    out = {"attempted": w.attempted, "failed": w.attempted - len(w.ok)}
    if args.trace:
        b = w.traced
        print(f"perfbench: traced slice of {b.attempted}, span {b.trace_window}, read in "
              f"{b.trace_read_s} s, events by category {b.trace.counts if b.trace else None}",
              file=sys.stderr, flush=True)
        if b.trace is not None:
            dev.update(busy_s=b.trace.busy_seconds(), window_s=b.trace.seconds)
            out["breakdown"] = breakdown(b.trace)
    print(f"perfbench: {args.workload} seed {args.seed}: {out['attempted']} requests, "
          f"{out['failed']} failed; load generator {w.loadgen}; setup_s {w.setup_s:.3f}",
          file=sys.stderr, flush=True)
    bench.close()
    t0 = time.monotonic()
    judge = check.Judge(bench.paths, device)
    readings = check.judge(judge, {r.i: r for r in reqs}, w.records, smp, kept)
    del judge
    print(f"perfbench: the reference judged {sum(map(len, smp.values()))} requests in "
          f"{time.monotonic() - t0:.1f} s", file=sys.stderr, flush=True)
    limits = bench.params["limits"]  # the numbers compared, each with its limit
    correct = all(readings[n] <= lim for n, lim in limits.items())
    print(f"perfbench: readings {readings}", file=sys.stderr, flush=True)
    return {"correct": correct, **out, "metrics": metrics, "device": dev,
            "check": {n: {"value": finite(readings[n]), "limit": lim}
                      for n, lim in limits.items()}}


def main(argv=None) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    # a run that has not ended by then prints every thread's stack and exits
    faulthandler.dump_traceback_later(345, exit=True)
    bench = harness.Bench(args.workload)
    if torch.cuda.device_count() < int(bench.cell["chips"]):
        print(f"perfbench: {args.workload} needs {bench.cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-"))
    try:
        result = run(args, torch.device("cuda"), bench, tmp)
    finally:
        bench.close()
        shutil.rmtree(tmp, ignore_errors=True)
    found = harness.banned_modules()
    if found:
        print(f"perfbench: loaded {found}, which the port's benchmark must never load",
              file=sys.stderr)
        return 3
    for n, c in result["check"].items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
