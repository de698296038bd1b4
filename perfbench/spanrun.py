"""Windows of one cell with the program's span recorder on or off, in
turns, after one set-up: what the recorder costs end to end, and what its
per-layer metrics read over whole windows.

    python3 -m perfbench.spanrun --workload NAME --seed N --seconds S \
        --modes off,on,on,off,off,on

Set-up as ``perfbench.run``'s (the weights from ``--seed``, the server
with its warm-up complete); then one window a mode, each of the cell's
traffic drawn from its own seed (``--seed`` + 1, + 2, ...): ``on`` runs it
with the recorder on (``spans.recorded_window``), ``off`` without. Each
window prints one JSON line: its mode and seed, the requests attempted and
failed, the cell's end-to-end metrics and the TTFA's median, and, with the
recorder on, the metrics that read its spans (``SPAN_METRICS``), the
recorder's counts and the device's idle time put down to host ranges
(``spans.idle_by_host``). No correctness check: ``perfbench.run`` judges
the same program. Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from . import harness, spans

SPAN_METRICS = ("codec.queue_ms_mean", "batcher.attach_ms_mean", "llm.device_ms_per_step",
                "codec.device_ms_per_decode", "device.window_idle_share")
ALWAYS = ("latency_p50_ms", "latency_p95_ms", "ttfa_p50_ms", "ttfa_p95_ms")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def window_line(w, mode: str, seed: int) -> dict:
    line = {"mode": mode, "seed": seed, "attempted": w.attempted,
            "failed": w.attempted - len(w.ok)}
    names = ALWAYS + (SPAN_METRICS if mode == "on" else ())
    line["metrics"] = {n: harness.metric_reader(n)(w) for n in names}
    if mode == "on":
        line["recorder"] = getattr(w, "recorder", None)
        line["idle_by_host"] = spans.idle_by_host(w)
        line["busy_s"] = spans.busy_seconds(w)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.spanrun")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", default="off,on,on,off")
    ap.add_argument("--out", help="also append each line to this file")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    if set(modes) - {"on", "off"}:
        ap.error("--modes takes on and off")
    if not torch.cuda.is_available():
        print("perfbench.spanrun: no CUDA card", file=sys.stderr)
        return 2
    from miotts_tpu_torch.device import select_device

    device = torch.device("cuda")
    select_device(device.type)
    bench = harness.Bench(args.workload)
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-spans-"))
    try:
        bench.setup(tmp, args.seed, device)
        print(json.dumps({"card": card(), "workload": args.workload, "seed": args.seed}),
              flush=True)
        for k, mode in enumerate(modes, 1):
            seed = args.seed + k
            reqs = bench.schedule(seed, args.seconds)
            if mode == "on":
                w = spans.recorded_window(bench, reqs, args.seconds)
            else:
                w = bench.window(reqs, args.seconds)
            line = json.dumps(window_line(w, mode, seed))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    finally:
        bench.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
