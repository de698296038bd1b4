"""Kernel K3: activation times Q8_0 weights, dequantized in the tile, f32 out.

Wraps ``csrc/q8_matmul.cu`` (replaces the Pallas kernel
miotts_tpu/ops/pallas/quant_matmul.py::q8_matmul). A CPU tensor takes the
plain version; a CUDA tensor launches the kernel, or raises on anything the
kernel does not take. Unlike the TPU kernel, which needs T padded to 16
rows, the kernel takes any T >= 1 and tiles it itself. One launch a call,
on one of two paths that ``launch_shape`` picks from the shapes: at decode
(T <= 8) a layer leaf runs as a GEMV (16 columns a block, the block's
threads split K); the logits head and larger T stream the weights through
a cp.async ring, and where K is split the splits are one thread-block
cluster that sums its partials through distributed shared memory.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import build, graphs

SOURCE = "miotts_tpu_torch/csrc/q8_matmul.cu"
REPLACES = "miotts_tpu/ops/pallas/quant_matmul.py:50"

QBLOCK = 32  # Q8_0 block size along the contraction dim

# launches of the CUDA kernel in this process (the plain version and
# refusals do not count); callers may reset it to 0
launches = 0

SMS = 132  # H100 SXM streaming multiprocessors: the plan gives each a block
RING_TN = 128  # columns of a ring block (csrc/q8_matmul.cu kTN)
RING_BYTES = 8 * (QBLOCK * RING_TN + 4 * RING_TN)  # its cp.async ring (kRingBytes)
PORTABLE_CLUSTER = 8  # blocks of a cluster without the non-portable attribute
MAX_CLUSTER = 16  # with it (the kernel sets it above 8)
MAX_SMEM = 227 * 1024  # opt-in shared memory of one block on sm_90

GEMV_MAX_WEIGHTS = 1 << 24  # K * N up to this takes the GEMV path at T <= 8
GEMV_TN = 16  # columns of a GEMV block (one 16-byte load of q a row)
GEMV_SMEM = 4 * (256 * 17 + 16 * 16)  # its static shared memory: tr[256][17], grp[16][16]

_fn = None
_gemv = None


class Plan(NamedTuple):
    """One launch of the kernel: its path ("gemv" or "ring"), row tile,
    column tile, K splits (one cluster along grid.z) of ``per`` Q8_0 blocks
    each, grid, shared bytes."""
    kind: str
    tt: int
    tn: int
    z: int
    per: int
    grid: tuple[int, int, int]
    smem: int


def _gemv_entry():
    global _gemv
    if _gemv is None:
        fn = build.load_library().miotts_q8_gemv
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _gemv = fn
    return _gemv


def _entry():
    global _fn
    if _fn is None:
        fn = build.load_library().miotts_q8_matmul
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def smem_bytes(tt: int, per: int, x_bytes: int) -> int:
    """Shared bytes of one block (csrc/q8_matmul.cu smem_bytes): the
    cp.async ring, the raw x tile, the bf16-rounded x tile, the row groups'
    sums and the slices of the cluster's partials the block receives."""
    span = per * QBLOCK
    return (RING_BYTES + -(-tt * span * x_bytes // 16) * 16
            + 4 * (tt * span + 1024 * tt + tt * RING_TN + MAX_CLUSTER))


def launch_shape(T: int, K: int, N: int, x_bytes: int = 2, aligned: bool = True) -> Plan:
    """The launch plan for x [T, K] (``x_bytes`` a value) and q [K, N]
    (``aligned``: q 16-byte aligned); it depends on these only, never on
    data.

    TT is the least of 1, 2, 4, 8 that covers T (larger T is tiled over
    grid.y). At T <= 8, a weight of at most GEMV_MAX_WEIGHTS with N % 16 ==
    0 (every layer leaf of the 0.1B LLM) takes the GEMV path: a block of 16
    columns and all of K, no split. Else the ring path: blocks of 128
    columns, and K split (up to 8 ways, by whole Q8_0 blocks, none empty)
    just enough that every SM has a block; splits grow past 8 (up to 16)
    only if the x tile would not fit the shared memory."""
    tt = next(v for v in (1, 2, 4, 8) if T <= v or v == 8)
    nkb = K // QBLOCK
    rows = math.ceil(T / tt)
    if T <= 8 and N % GEMV_TN == 0 and K * N <= GEMV_MAX_WEIGHTS and aligned:
        return Plan("gemv", tt, GEMV_TN, 1, nkb, (N // GEMV_TN, rows, 1), GEMV_SMEM)
    tiles = math.ceil(N / RING_TN) * rows
    per = math.ceil(nkb / max(1, min(PORTABLE_CLUSTER, nkb, math.ceil(SMS / tiles))))
    while smem_bytes(tt, per, x_bytes) > MAX_SMEM and math.ceil(nkb / per) < min(MAX_CLUSTER, nkb):
        per = math.ceil(nkb / (math.ceil(nkb / per) + 1))
    z = math.ceil(nkb / per)
    return Plan("ring", tt, RING_TN, z, per, (math.ceil(N / RING_TN), rows, z),
                smem_bytes(tt, per, x_bytes))


def q8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [T, K] bf16/f32, q [K, N] int8, s [K/32, N]
    f32 -> [T, N] f32. Both operands are rounded to bf16 as the TPU kernel's
    tile does; the f32 product of bf16 values is exact, then summed in f32."""
    w = (q.float() * s.repeat_interleave(QBLOCK, dim=0)).to(torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ w


def q8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: plain version on the CPU, the kernel on CUDA.
    x [T, K] bf16 or f32, q [K, N] int8, s [K/32, N] f32 -> [T, N] f32."""
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
    plan = launch_shape(T, K, N, x.element_size(), q.data_ptr() % 16 == 0)
    if plan.smem > MAX_SMEM:
        raise ValueError(f"q8 matmul: x {tuple(x.shape)} needs {plan.smem} bytes of shared memory")
    out = torch.empty((T, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), int(x.dtype == torch.float32), q.data_ptr(), s.data_ptr(),
            out.data_ptr(), T, K, N, plan.tt)
    if plan.kind == "gemv":
        status = build.launch(x.device, _gemv_entry(), *args, stream)
    else:
        status = build.launch(x.device, _entry(), *args, plan.z, plan.per, stream)
    build.check(status, "q8_matmul")
    graphs.launched(__name__)
    return out
