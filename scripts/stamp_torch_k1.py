#!/usr/bin/env python3
"""Where a warp of kernel K1 (banded attention) spends its cycles, on the card.

    python3 scripts/stamp_torch_k1.py [--iters 20]

Builds the kernels with ``-DMIOTTS_STAMPS`` into a library of their own
(``build.build(defines=...)``): lane 0 of every warp of K1 then adds the
clock64 cycles of each phase (0 the staging copies issued, from the
kernel's start; 1 their wait and the block barrier; 2 scores; 3 softmax; 4
values and stores) to a device counter. At each of
chip_smoke.py's K1 request shapes it runs the stamped kernel ``--iters``
times and prints the mean cycles a warp spends in each phase, the warps
launched, and the stamped kernel's time (chip_smoke.cuda_ms), beside the
SM clock nvidia-smi reads. Prints the card's name and power limit first and
one JSON object last. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import K1_SHAPES, K1_WINDOW, cuda_ms  # noqa: E402
from miotts_tpu_torch.device import select_device  # noqa: E402
from miotts_tpu_torch.ops.cuda import banded_attention as k1  # noqa: E402
from miotts_tpu_torch.ops.cuda import build  # noqa: E402

PHASES = ("copies issued", "copies waited", "scores", "softmax", "values")


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stamp_torch_k1: needs a CUDA card", file=sys.stderr)
        return 2
    dev = select_device("cuda")
    print(smi("name,power.limit"), flush=True)
    lib = ctypes.CDLL(str(build.build(defines=("MIOTTS_STAMPS",))))
    fn = lib.miotts_banded_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    read = lib.miotts_banded_attention_stamps
    fn.restype = ctypes.c_int
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    stamps = (ctypes.c_ulonglong * len(PHASES))()
    gen = torch.Generator().manual_seed(0)
    result = {"device": torch.cuda.get_device_name(0), "shapes": {}}
    for name, B, H, T, lens in K1_SHAPES:
        q, k, v = (torch.randn(B, T, H, 64, generator=gen).to(dev) for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        plan = k1.launch_shape(B, T, H, 64, K1_WINDOW)
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                        out.data_ptr(), B, T, H, 64, K1_WINDOW // 2, plan.warps, 0.125, stream)
            build.check(status, "banded_attention (stamped)")

        launch()
        torch.cuda.synchronize()
        build.check(read(stamps), "stamps")  # zeroes them
        for _ in range(args.iters):
            launch()
        torch.cuda.synchronize()
        build.check(read(stamps), "stamps")
        # every warp stamps the copies it issued; those past T then exit
        launched = plan.grid[0] * plan.warps * H * B
        warps = sum(min(plan.warps, -(-(T - t0) // k1.ROWS))
                    for t0 in range(0, T, plan.tile)) * H * B
        per_warp = {p: stamps[i] / ((launched if i == 0 else warps) * args.iters)
                    for i, p in enumerate(PHASES)}
        ms = cuda_ms(launch, args.iters)
        clock = smi("clocks.sm")
        result["shapes"][name] = {"plan": list(plan), "warps": warps, "cycles_per_warp": per_warp,
                                  "stamped_ms": ms, "sm_clock": clock}
        print(f"[k1 stamps] {name} B={B} H={H} T={T} launch={tuple(plan)} warps={warps}: "
              + " ".join(f"{p}={c:.0f}" for p, c in per_warp.items())
              + f" cycles a warp (sum {sum(per_warp.values()):.0f}); stamped kernel "
              f"{ms * 1e3:.2f} us at SM clock {clock}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
