"""Kernel K1: banded attention in the codec trunk's [B, T, H, D] layout.

Wraps ``csrc/banded_attention.cu`` (replaces the Pallas kernel
miotts_tpu/ops/pallas/banded_attention.py::banded_attention_pallas). A CPU
tensor takes the plain version (``ops/attention.py``
``banded_attention_plain``); a CUDA tensor launches the kernel, or raises
on anything the kernel does not take. The kernel reads q/k/v and writes
the output in place of their layout: no fold copies.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..attention import banded_attention_plain
from . import build, graphs

SOURCE = "miotts_tpu_torch/csrc/banded_attention.cu"
REPLACES = "miotts_tpu/ops/pallas/banded_attention.py:33"

# launches of the CUDA kernel in this process (the plain version and
# refusals do not count); callers may reset it to 0
launches = 0

_SMS = 132  # H100 SXM streaming multiprocessors
MAX_SMEM = 227 * 1024  # opt-in shared memory of one block on sm_90
ROWS = 4  # query rows a warp (csrc kRows)
TILE_WARPS = (8, 4)  # warps a block, largest first: 32- and 16-row query tiles
MAX_SLOTS = 8  # 32-key slots a lane may hold: half <= 126

_fn = None


class Plan(NamedTuple):
    """One launch of csrc/banded_attention.cu: a block of ``warps`` warps
    (ROWS query rows each) owns ``tile`` query rows of one (example, head);
    grid (ceil(T / tile), H, B). ``slots`` 32-key slots a lane;
    ``compiled`` whether the D = 64 instance runs (else the run-time
    width's)."""
    warps: int
    tile: int
    slots: int
    smem: int
    compiled: bool
    grid: tuple[int, int, int]


def launch_shape(B: int, T: int, H: int, D: int, window: int) -> Plan:
    """The larger tile whose grid gives every SM a block, else the 16-row
    tile (a sweep of 4- and 8-row warps and 2-8 warps a block on the H100
    found these the fastest at a request's shapes: scripts/bench_torch_k1_k5.py
    --sweep). Raises
    ValueError for a window or width the kernel refuses."""
    half = max(0, window // 2)
    slots = math.ceil((ROWS + 2 * half) / 32)
    for warps in TILE_WARPS:
        tile = warps * ROWS
        grid = (math.ceil(T / tile), H, B)
        if math.prod(grid) >= _SMS or warps == TILE_WARPS[-1]:
            break
    width = -(-D // 4) * 4 + 4  # the staged row stride
    smem = 4 * ((tile + 2 * (tile + 2 * half)) * width + tile * (ROWS + 2 * half))
    if slots > MAX_SLOTS or smem > MAX_SMEM:
        raise ValueError(f"banded attention: window {window} and head width {D} need "
                         f"{slots} key slots a lane and {smem} bytes of shared memory "
                         f"(at most {MAX_SLOTS} and {MAX_SMEM})")
    return Plan(warps, tile, slots, smem, D == 64 and slots <= 3, grid)


def _entry():
    global _fn
    if _fn is None:
        fn = build.load_library().miotts_banded_attention_f32
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def banded_attention(q, k, v, lengths, window: int) -> torch.Tensor:
    """q/k/v: [B, T, H, D] f32 contiguous, lengths [B] int32 ->
    [B, T, H, D] f32 contiguous."""
    if q.device.type == "cpu":
        return banded_attention_plain(q, k, v, lengths, window)
    if q.dim() != 4:
        raise ValueError(f"banded attention: q {list(q.shape)} must be [B, T, H, D]")
    B, T, H, D = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape:
            raise ValueError(f"banded attention: {name} shape {list(x.shape)} != q {list(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32 or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"banded attention: {name} must be contiguous f32 on {q.device}, "
                             f"got {x.dtype} on {x.device}"
                             + ("" if x.is_contiguous() else ", not contiguous"))
    if (lengths.dtype != torch.int32 or lengths.device != q.device
            or lengths.shape != (B,) or not lengths.is_contiguous()):
        raise ValueError(f"banded attention: lengths must be contiguous int32 [{B}] on "
                         f"{q.device}, got {lengths.dtype} {list(lengths.shape)}")
    if not 0 < B <= 65535 or not 0 < H <= 65535 or T < 1 or D < 1:
        raise ValueError(f"banded attention: unsupported shape {list(q.shape)}")
    plan = launch_shape(B, T, H, D, window)
    if q.device.type != "cuda":
        raise ValueError(f"banded attention: unsupported device {q.device}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.launch(q.device, _entry(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          lengths.data_ptr(), out.data_ptr(), B, T, H, D, max(0, window // 2),
                          plan.warps, 1.0 / math.sqrt(D), stream)
    build.check(status, "banded_attention")
    graphs.launched(__name__)
    return out
