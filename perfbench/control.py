"""The readings a cell's limits are set from: the program's, over many
traffic seeds, and its controls', one precision below what the
configuration states.

    python3 -m perfbench.control --workload NAME --seed N --seconds S --seeds A B C ...
    python3 -m perfbench.control ... --llm-quant q8_0

One set-up (the weights from ``--seed``), then for each of ``--seeds`` a
window of the cell's own traffic at its own rate, long enough to finish
its longest requests, judged as a run judges it (``check.judge``) and,
beside that, by the reference's controls: the LLM's matmul weights
rounded through float8 e4m3 and through int8 (one scale a row; the gap
read is that of the token the lower precision puts first), and the codec
decoded with TF32 on (``wav_err.tf32``, ``stream_err.tf32``: the TF32
decode against the f32 reference). With ``--llm-quant Q`` the program
itself is the control: its server runs the LLM through its own ``Q`` path
(``q8_0``: int8 weights with one scale a 32-weight block, through K3), and
its readings are the control's, named ``<number>.Q``. Prints one JSON line
a seed, then the largest program reading and the smallest control reading
of each number. The benchmark's own runs never run this. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
import tempfile
from pathlib import Path

import torch

from perfbench import check, harness

QUANTS = ("fp8", "int8")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--llm-quant", default="",
                    help="serve the LLM through the program's own lower-precision path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    from miotts_tpu_torch.device import select_device

    dev = select_device("cuda")
    bench = harness.Bench(args.workload)
    q = args.llm_quant
    if q:
        bench.extra_flags = ["--llm-quant", q]
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-control-"))
    rows = []
    try:
        bench.setup(tmp, args.seed, dev)
        print(f"perfbench.control: the server's llm_quant {bench.health().get('llm_quant')!r}",
              file=sys.stderr, flush=True)
        judge = check.Judge(bench.paths, dev, quants=() if q else QUANTS)
        for s in args.seeds:
            reqs = bench.schedule(s, args.seconds)
            smp = bench.sample(reqs, s)
            w = bench.window(reqs, args.seconds, keep=set(smp["wav"]) | set(smp["stream"]))
            r = check.judge(judge, {q.i: q for q in reqs}, w.records, smp,
                            tmp / f"window{bench.n_windows}" / "keep", control=not q)
            if q:
                r = {f"{k}.{q}": v for k, v in r.items()}
            rows.append({"seed": s, "failed": w.attempted - len(w.ok), **r})
            print(json.dumps(rows[-1]), flush=True)
    finally:
        bench.close()
        shutil.rmtree(tmp, ignore_errors=True)
    keys = [k for k in rows[0] if k not in ("seed", "failed")]
    top = {k: (max if k in check.NAMES else min)(r[k] for r in rows) for k in keys}
    print(json.dumps({"workload": args.workload, "llm_quant": q or None,
                      "program_max": {k: top[k] for k in keys if k in check.NAMES},
                      "control_min": {k: top[k] for k in keys if k not in check.NAMES},
                      "finite": all(math.isfinite(v) for v in top.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
