"""Kernel K6: one AMP resblock layer of the mel vocoder in one launch,
conv2(actB(conv1(actA(x), dilation))) + x, intermediates on chip.

Wraps ``csrc/resblock.cu`` (replaces the Pallas kernel
miotts_tpu/ops/pallas/resblock.py::fused_resblock_layer). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel, or raises on
anything the kernel does not take. Activations are dicts with ``alpha``,
``beta`` [C] and 1-D ``up_filter``/``down_filter``, as in the weight tree.

``launch_shape`` computes the kernel's tile plan (rows a block, the rows of
each stage, shared bytes); the wrapper passes it in. The weights in the
kernel's [k, Cin, Cout] layout and the snake coefficients are made once for
each weight tensor (while it is alive and unchanged) and kept.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import build, graphs
from .activation1d import (
    act_geom, activation1d_plain, activation_operands, cached, check_act)
from .conv1d import check_f32, conv1d_same_plain, device_lengths

SOURCE = "miotts_tpu_torch/csrc/resblock.cu"
REPLACES = "miotts_tpu/ops/pallas/resblock.py:249"

# launches of the CUDA kernel in this process (the plain version and
# refusals do not count); callers may reset it to 0
launches = 0

MAX_SMEM = 227 * 1024  # opt-in shared memory of one block on sm_90
# the kernel's tile plans, tried in order: (conv1, conv2) GEMM rows
VARIANTS = ((144, 128), (80, 64))
_CHUNK, _XPAD, _TN = 32, 4, 128  # conv_gemm.cuh kChunk, kXPad; resblock.cu kTN

_fn = None


class Plan(NamedTuple):
    """One launch of csrc/resblock.cu. A block owns n_out output rows from
    t0; rows are relative to t0: the input window [-halo_lo, -halo_lo +
    window), actA's rows (conv1's window) act_a_rows, conv1's rows tm1
    (actB's input), actB's rows n_out + 2 half2 (conv2's window), conv2's
    rows tm2 >= n_out. rows_in and rows_a are the two row buffers."""
    variant: int
    n_out: int
    tm1: int
    tm2: int
    halo_lo: int
    window: int
    act_a_rows: int
    rows_in: int
    rows_a: int
    smem: int
    grid: tuple[int, int]


def launch_shape(B: int, T: int, C: int, k1c: int, dilation: int, k2c: int,
                 taps_a: tuple[int, int] = (12, 12), taps_b: tuple[int, int] = (12, 12)) -> Plan:
    """The tile plan for x [B, T, C], convs of k1c (dilation) and k2c taps
    and activations of (up, down) taps ``taps_a`` and ``taps_b``: the first
    of VARIANTS whose buffers fit the shared memory, with as many output
    rows as conv1's rows can feed (at most conv2's). Raises ValueError when
    none fits."""
    gA, gB = act_geom(*taps_a), act_geom(*taps_b)
    half1, half2 = (k1c - 1) // 2 * dilation, (k2c - 1) // 2
    xs = math.ceil(C / _CHUNK) * _CHUNK + _XPAD
    for v, (tm1, tm2) in enumerate(VARIANTS):
        n_out = min(tm2, tm1 - 2 * half2 - gB.hlo - gB.hhi)
        n1 = tm1 + 2 * half1
        na = n1 + gA.hlo + gA.hhi
        rows_in, rows_a = max(na, tm1), max(n1, tm2 + 2 * half2)
        smem = 4 * ((rows_in + rows_a) * xs + 2 * _CHUNK * _TN)
        if n_out >= 1 and smem <= MAX_SMEM:
            return Plan(v, n_out, tm1, tm2, half2 + gB.hlo + half1 + gA.hlo, na, n1, rows_in,
                        rows_a, smem, (math.ceil(T / n_out), B))
    raise ValueError(f"resblock_layer: no tile plan fits {MAX_SMEM} bytes of shared memory at "
                     f"C={C}, k={k1c}/{k2c}, dilation {dilation}, taps {taps_a}/{taps_b}")


def _entry():
    global _fn
    if _fn is None:
        fn = build.load_library().miotts_resblock_layer_f32
        act = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_void_p]
        fn.argtypes = ([ctypes.c_void_p] * 2 + act + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + act + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _act_plain(x, lengths, act):
    return activation1d_plain(x, lengths, act["up_filter"], act["alpha"], act["beta"],
                              act["down_filter"])


def resblock_layer_plain(x, lengths, actA, w1, b1, dilation: int, actB, w2, b2) -> torch.Tensor:
    """Plain PyTorch version, the JAX package's unfused chain: K5, K4, K5,
    K4 + residual, each as its plain version."""
    r1 = _act_plain(x, lengths, actA)
    r2 = conv1d_same_plain(r1, lengths, w1, b1, dilation)
    r3 = _act_plain(r2, lengths, actB)
    return conv1d_same_plain(r3, lengths, w2, b2, 1, residual=x)


def resblock_layer(x, lengths, actA, w1, b1, dilation: int, actB, w2, b2) -> torch.Tensor:
    """x [B, T, C] f32, lengths [B], w1/w2 [C, C, k] (odd k), b1/b2 [C] ->
    [B, T, C] f32, rows t >= length 0."""
    if x.device.type == "cpu":
        return resblock_layer_plain(x, lengths, actA, w1, b1, dilation, actB, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_layer: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"resblock_layer: x {list(x.shape)} must be [B, T, C]")
    B, T, C = x.shape
    if C % 4 or dilation < 1 or not 0 < B <= 65535:
        raise ValueError(f"resblock_layer: x {list(x.shape)}, dilation {dilation}: need "
                         f"C % 4 == 0")
    check_f32("x", x, (B, T, C), x.device, "resblock_layer")
    for name, w, b in (("w1", w1, b1), ("w2", w2, b2)):
        if w.dim() != 3 or w.shape[-1] % 2 == 0:
            raise ValueError(f"resblock_layer: {name} {list(w.shape)} must be [C, C, odd k]")
        check_f32(name, w, (C, C, w.shape[-1]), x.device, "resblock_layer")
        check_f32(name.replace("w", "b"), b, (C,), x.device, "resblock_layer")
    check_act(actA, C, x.device, "resblock_layer actA")
    check_act(actB, C, x.device, "resblock_layer actB")
    for name, t in (("x", x), ("b1", b1), ("b2", b2)):
        if t.data_ptr() % 16:
            raise ValueError(f"resblock_layer: {name} must be 16-byte aligned")
    opsA, opsB = (cached(tuple(act[k] for k in ("up_filter", "down_filter", "alpha", "beta")),
                          lambda act=act: activation_operands(act, x.device))
                  for act in (actA, actB))
    w1_kio, w2_kio = (cached((w,), lambda w=w: w.permute(2, 1, 0).contiguous())  # [k, Cin, Cout]
                      for w in (w1, w2))
    plan = launch_shape(B, T, C, w1.shape[-1], dilation, w2.shape[-1],
                        (opsA[0].shape[0], opsA[1].shape[0]), (opsB[0].shape[0], opsB[1].shape[0]))
    lens = device_lengths(lengths, B, x.device)
    out = torch.empty_like(x)

    def act_args(fu, fd, a, inv):
        return (fu.data_ptr(), fu.shape[0], fd.data_ptr(), fd.shape[0], a.data_ptr(),
                inv.data_ptr())

    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = build.launch(x.device, _entry(), x.data_ptr(), lens.data_ptr(), *act_args(*opsA),
                          w1_kio.data_ptr(), b1.data_ptr(), w1.shape[-1], dilation,
                          *act_args(*opsB), w2_kio.data_ptr(), b2.data_ptr(), w2.shape[-1],
                          out.data_ptr(), B, T, C, plan.variant, plan.n_out, stream)
    build.check(status, "resblock_layer")
    graphs.launched(__name__)
    return out
