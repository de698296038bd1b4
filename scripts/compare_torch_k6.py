#!/usr/bin/env python3
"""Hold kernel K6's outputs (the fused vocoder resblock layer) of this tree
against those of another tree, bit for bit, on the card.

    python3 scripts/compare_torch_k6.py --save DIR       # in tree A
    python3 scripts/compare_torch_k6.py --compare DIR    # in tree B

Runs K6 on chip_smoke.py's K6 inputs (the same seed, so the same tensors in
both trees): the three vocoder shapes at d = 1, 3 and 5, the k = 11 conv
(the small tile) and the 16/20-tap filters (the generic activation).
``--save`` writes each output to DIR; ``--compare`` reads them back and
prints, for each case, whether the outputs are bit-equal and the largest
absolute difference. Imports the package of the tree it lies in. Prints
the card's name and power limit first and one JSON object last; exits 1
if any case differs. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import VOC_SHAPES, VOCODER_CH, voc_act, voc_inputs  # noqa: E402
from miotts_tpu_torch.device import select_device  # noqa: E402
from miotts_tpu_torch.ops.cuda import resblock as k6  # noqa: E402


def cases(dev):
    """(name, K6 arguments) in a fixed order from one seed, as chip_smoke's
    check_k6 makes them."""
    gen = torch.Generator().manual_seed(0)
    C = VOCODER_CH
    actA, actB = voc_act(dev, gen), voc_act(dev, gen)
    w1, w2 = ((torch.randn(C, C, 3, generator=gen) * 0.05).to(dev) for _ in range(2))
    b1, b2 = ((torch.randn(C, generator=gen) * 0.02).to(dev) for _ in range(2))
    for B, T, lens in VOC_SHAPES:
        x, L = voc_inputs(dev, gen, B, T, lens)
        for d in (1, 3, 5):
            yield f"B={B} T={T} d={d}", (x, L, actA, w1, b1, d, actB, w2, b2)
    x, L = voc_inputs(dev, gen, 2, 2560, [2560, 1777])
    wide = [(torch.randn(C, C, 11, generator=gen) * 0.02).to(dev) for _ in range(2)]
    f16 = voc_act(dev, gen)
    f16["up_filter"] = torch.hann_window(18, periodic=False, device=dev)[1:-1] / 8.0
    f16["down_filter"] = torch.hann_window(22, periodic=False, device=dev)[1:-1] / 10.0
    yield "B=2 T=2560 k=11 d=5", (x, L, actA, wide[0], b1, 5, actB, wide[1], b2)
    yield "B=2 T=2560 taps 16/20 d=3", (x, L, f16, w1, b1, 3, f16, w2, b2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", type=Path)
    mode.add_argument("--compare", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_k6: needs a CUDA card", file=sys.stderr)
        return 2
    dev = select_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.save:
        args.save.mkdir(parents=True, exist_ok=True)
    result = {}
    for i, (name, kargs) in enumerate(cases(dev)):
        out = k6.resblock_layer(*kargs).cpu()
        path = (args.save or args.compare) / f"k6_{i}.pt"
        if args.save:
            torch.save(out, path)
            print(f"[k6] {name}: saved", flush=True)
            continue
        ref = torch.load(path)
        equal = torch.equal(out, ref)
        diff = (out - ref).abs().max().item()
        result[name] = {"bit_equal": equal, "max_abs_diff": diff}
        print(f"[k6] {name}: bit_equal={equal} max_abs_diff={diff:.3e}", flush=True)
    print(json.dumps(result))
    return 0 if all(r["bit_equal"] for r in result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
