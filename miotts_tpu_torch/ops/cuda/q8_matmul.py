"""Kernel K3: activation times Q8_0 weights, dequantized in the tile, f32 out.

Wraps ``csrc/q8_matmul.cu`` (replaces the Pallas kernel
miotts_tpu/ops/pallas/quant_matmul.py::q8_matmul). A CPU tensor takes the
plain version; a CUDA tensor launches the kernel, or raises on anything the
kernel does not take. Unlike the TPU kernel, which needs T padded to 16
rows, the kernel takes any T >= 1 and tiles it itself.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

SOURCE = "miotts_tpu_torch/csrc/q8_matmul.cu"
REPLACES = "miotts_tpu/ops/pallas/quant_matmul.py:50"

QBLOCK = 32  # Q8_0 block size along the contraction dim

# launches of the CUDA kernel in this process (the plain version and
# refusals do not count); callers may reset it to 0
launches = 0

_SMS = 132  # H100 SXM streaming multiprocessors: the split-K target is 2 blocks each
_TILE_N = 128  # output columns of one block (csrc/q8_matmul.cu kTileN)
_WARPS = 8  # warps of one block, which split its K range (kWarps)
_SMEM_TILE = 96 * 1024  # bytes of x tile a block may stage: keeps two blocks an SM

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load_library().miotts_q8_matmul
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch_shape(T: int, K: int, N: int) -> tuple[int, int]:
    """(row tile TT, K splits Z) for x [T, K] and q [K, N].

    TT is the least of 1, 2, 4, 8 that covers T (larger T is tiled). K is
    split over Z blocks of the grid when the column and row tiles give fewer
    than two blocks an SM, with at least one Q8_0 block for each warp of a
    split, and further when the x tile [TT, K/Z] would not fit the shared
    memory budget."""
    tt = next(v for v in (1, 2, 4, 8) if T <= v or v == 8)
    nkb = K // QBLOCK
    blocks = math.ceil(N / _TILE_N) * math.ceil(T / tt)
    z = 1
    if blocks < 2 * _SMS:
        z = max(1, min(math.ceil(2 * _SMS / blocks), nkb // _WARPS))
    while tt * math.ceil(nkb / z) * QBLOCK * 4 > _SMEM_TILE:
        z += 1
    return tt, math.ceil(nkb / math.ceil(nkb / z))


def q8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [T, K] bf16/f32, q [K, N] int8, s [K/32, N]
    f32 -> [T, N] f32. Both operands are rounded to bf16 as the TPU kernel's
    tile does; the f32 product of bf16 values is exact, then summed in f32."""
    w = (q.float() * s.repeat_interleave(QBLOCK, dim=0)).to(torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ w


def q8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: plain version on the CPU, the kernel on CUDA.
    x [T, K] bf16 or f32, q [K, N] int8, s [K/32, N] f32 -> [T, N] f32."""
    global launches
    if x.device.type == "cpu":
        return q8_matmul_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"q8 matmul: unsupported device {x.device}")
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"q8 matmul: x {tuple(x.shape)} and q {tuple(q.shape)} must be 2-D")
    T, K = x.shape
    N = q.shape[1]
    if T < 1 or K % QBLOCK or N % 4 or tuple(q.shape) != (K, N) or tuple(s.shape) != (K // QBLOCK, N):
        raise ValueError(f"q8 matmul: x {tuple(x.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)}: "
                         f"need q [K, N], s [K/32, N], K % 32 == 0, N % 4 == 0")
    for name, t, dtypes, align in (("x", x, (torch.bfloat16, torch.float32), 4),
                                   ("q", q, (torch.int8,), 4), ("s", s, (torch.float32,), 16)):
        if (t.dtype not in dtypes or t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % align):
            raise ValueError(f"q8 matmul: {name} must be contiguous, {align}-byte aligned "
                             f"{' or '.join(map(str, dtypes))} on {x.device}")
    tt, z = launch_shape(T, K, N)
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    partial = torch.empty((z, T, N), dtype=torch.float32, device=x.device) if z > 1 else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry()(x.data_ptr(), int(x.dtype == torch.float32), q.data_ptr(), s.data_ptr(),
                      out.data_ptr(), None if partial is None else partial.data_ptr(),
                      T, K, N, tt, z, stream)
    build.check(status, "q8_matmul")
    launches += 1
    return out
