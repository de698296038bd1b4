#!/usr/bin/env python3
"""Time kernels K1 (banded attention) and K5 (anti-aliased snake) of the
PyTorch/CUDA port on the card, at the shapes a request gives them.

    python3 scripts/bench_torch_k1_k5.py [--iters 20]

K1 at the codec's attention shapes (D = 64, window 65): the prenet (H = 12)
and the decoder (H = 8) of a 400-code request (T = 512 and 1024, lengths
400 and 800) and of a 40-code one (T = 64 and 128, lengths 40 and 80), and
B = 1 H = 8 T = 1024 at length 954 (chip_smoke.py's timed shape). Each line
gives the kernel's own call, the op the codec trunk calls
(``ops.attention.banded_attention`` on [B, T, H, D], with whatever layout
copies it makes), the plain version, SDPA with the band mask, and the bound.

K5 at the mel vocoder's shapes (C = 128, 12/12-tap filters): stage 1 of a
400-code request (5 120 rows, 4 000 valid), a ragged pair (2 x 2 560), the
last stage (491 520 rows, 384 000 valid), stage 1 of a 40-code request (640
rows, 400 valid) and the post-activation of a 40-code request (61 440 rows,
38 400 valid); kernel, plain version and bound.

Beside them, the floor of the timing itself: one minimal PyTorch kernel (a
1-element ``add_``). ``--sweep`` (this tree's K5 and K1 only) also times K5
at other run lengths and block sizes and K1 at other warps a block, through
their C entry points.

Times are chip_smoke.cuda_ms: the mean of ``--iters`` back-to-back calls
behind a sleep kernel. Prints the card's name and power limit first and one
JSON object last. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import F32_FLOP_S, cuda_ms, least_time, voc_act, voc_inputs  # noqa: E402
from miotts_tpu_torch.device import select_device  # noqa: E402
from miotts_tpu_torch.ops import attention  # noqa: E402
from miotts_tpu_torch.ops.cuda import activation1d as k5  # noqa: E402
from miotts_tpu_torch.ops.cuda import banded_attention as k1  # noqa: E402
from miotts_tpu_torch.ops.cuda import build  # noqa: E402

WINDOW, HEAD_DIM = 65, 64
# (name, B, H, T, lengths)
K1_SHAPES = (("400 codes prenet", 1, 12, 512, [400]), ("400 codes decoder", 1, 8, 1024, [800]),
             ("40 codes prenet", 1, 12, 64, [40]), ("40 codes decoder", 1, 8, 128, [80]),
             ("chip_smoke", 1, 8, 1024, [954]))
# (name, B, T, lengths)
K5_SHAPES = (("400 codes stage 1", 1, 5120, [4000]), ("ragged pair", 2, 2560, [2560, 1777]),
             ("400 codes last stage", 1, 491520, [384000]), ("40 codes stage 1", 1, 640, [400]),
             ("40 codes post", 1, 61440, [38400]))


def band_mask(T: int, lengths: torch.Tensor) -> torch.Tensor:
    """[B, 1, T, T]: |k - q| <= window/2 and k < length, or k == q."""
    i = torch.arange(T, device=lengths.device)
    band = (i[None, :] - i[:, None]).abs() <= WINDOW // 2
    return ((band[None] & (i[None, None, :] < lengths[:, None, None]))
            | torch.eye(T, dtype=torch.bool, device=lengths.device)[None])[:, None]


def kernel_call(q, k, v, lengths):
    """K1's own launch, in the layout its wrapper takes."""
    # older trees' wrapper took folded [B*H, T, D] inputs and [B*H] lengths;
    # this lets the script time a parent commit beside this one
    if hasattr(k1, "banded_attention_folded"):
        B, T, H, D = q.shape
        fq, fk, fv = (x.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous() for x in (q, k, v))
        fl = lengths.repeat_interleave(H)
        return lambda: k1.banded_attention_folded(fq, fk, fv, fl, WINDOW)
    return lambda: k1.banded_attention(q, k, v, lengths, WINDOW)


def bench_k1(dev, gen, iters: int) -> dict:
    rows = {}
    for name, B, H, T, lens in K1_SHAPES:
        q, k, v = (torch.randn(B, T, H, HEAD_DIM, generator=gen).to(dev) for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = band_mask(T, lengths)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's [B, H, T, D]
        ms = cuda_ms(kernel_call(q, k, v, lengths), iters)
        op = cuda_ms(lambda: attention.banded_attention(q, k, v, lengths, WINDOW), iters)
        plain = cuda_ms(lambda: attention.banded_attention_plain(q, k, v, lengths, WINDOW), iters)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask), iters)
        nbytes = 4 * 4 * B * T * H * HEAD_DIM + 4 * B
        lb = least_time(nbytes, 4 * HEAD_DIM * H * int(mask.sum()), F32_FLOP_S)
        rows[name] = {"B": B, "H": H, "T": T, "lengths": lens, "kernel_ms": ms, "op_ms": op,
                      "plain_ms": plain, "sdpa_ms": lib, **lb}
        print(f"[k1] {name}: B={B} H={H} T={T} lengths={lens} kernel={ms:.4f}ms op={op:.4f}ms "
              f"plain={plain:.4f}ms SDPA={lib:.4f}ms bound={lb['bound_ms']:.5f}ms "
              f"({lb['bound_by']})", flush=True)
    return rows


def bench_k5(dev, gen, iters: int) -> dict:
    rows = {}
    for name, B, T, lens in K5_SHAPES:
        x, L = voc_inputs(dev, gen, B, T, lens)
        a = voc_act(dev, gen)
        args = (x, L, a["up_filter"], a["alpha"], a["beta"], a["down_filter"])
        ms = cuda_ms(lambda: k5.activation1d(*args), iters)
        plain = cuda_ms(lambda: k5.activation1d_plain(*args), iters)
        n, C = sum(lens), x.shape[-1]
        # as chip_smoke.check_k5 counts them
        lb = least_time(4 * (n * C + B * T * C + 12 + 12 + 2 * C),
                        (2 * (12 + 12) + 2 * 12) * n * C, F32_FLOP_S)
        rows[name] = {"B": B, "T": T, "lengths": lens, "kernel_ms": ms, "plain_ms": plain, **lb}
        print(f"[k5] {name}: B={B} T={T} lengths={lens} kernel={ms:.4f}ms plain={plain:.4f}ms "
              f"bound={lb['bound_ms']:.5f}ms ({lb['bound_by']})", flush=True)
        del x
    return rows


def sweep(dev, gen, iters: int) -> dict:
    """K5 at run lengths x block sizes, K1 at 2, 4 and 8 warps a block (ms)."""
    rows, stream = {}, torch.cuda.current_stream().cuda_stream
    for name, B, T, lens in K5_SHAPES:
        x, L = voc_inputs(dev, gen, B, T, lens)
        fu, fd, a, inv = k5.activation_operands(voc_act(dev, gen), dev)
        out = torch.empty_like(x)
        for run in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
            if -(-T // run) * 4 * B > 200_000:
                continue
            for warps in (8, 4, 2, 1):
                def launch():
                    build.check(k5._entry()(x.data_ptr(), L.data_ptr(), fu.data_ptr(), 12,
                                            fd.data_ptr(), 12, a.data_ptr(), inv.data_ptr(),
                                            out.data_ptr(), B, T, 128, run, warps, stream), "k5")
                ms = cuda_ms(launch, iters)
                rows[f"k5 {name} run={run} warps={warps}"] = ms
                print(f"[k5 sweep] {name}: run={run} warps={warps}: {ms:.4f}ms", flush=True)
        del x
    for name, B, H, T, lens in K1_SHAPES:
        q, k, v = (torch.randn(B, T, H, HEAD_DIM, generator=gen).to(dev) for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        for warps in (2, 4, 8):
            def launch():
                build.check(k1._entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        lengths.data_ptr(), out.data_ptr(), B, T, H, HEAD_DIM,
                                        WINDOW // 2, warps, 0.125, stream), "k1")
            ms = cuda_ms(launch, iters)
            rows[f"k1 {name} warps={warps}"] = ms
            print(f"[k1 sweep] {name}: warps={warps}: {ms:.4f}ms", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_k1_k5: needs a CUDA card", file=sys.stderr)
        return 2
    dev = select_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    build.load_library()
    gen = torch.Generator().manual_seed(0)
    one = torch.zeros(1, device=dev)
    floor = cuda_ms(lambda: one.add_(1), args.iters)
    print(f"[floor] one minimal kernel (1-element add_): {floor:.4f}ms", flush=True)
    result = {"device": torch.cuda.get_device_name(0),
              "power_limit": smi.stdout.strip().split(", ")[-1], "floor_ms": floor,
              "k1": bench_k1(dev, gen, args.iters), "k5": bench_k5(dev, gen, args.iters)}
    if args.sweep:
        result["sweep_ms"] = sweep(dev, gen, args.iters)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
