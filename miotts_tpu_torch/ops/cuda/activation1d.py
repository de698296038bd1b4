"""Kernel K5: BigVGAN's anti-aliased snake activation (Activation1d) in
[B, T, C] layout: 2x upsample -> ADAA snake-beta -> 2x downsample, length
unchanged.

Wraps ``csrc/activation1d.cu`` (replaces the Pallas kernel
miotts_tpu/ops/pallas/activation1d.py::fused_activation1d). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel, or raises on
anything the kernel does not take. The kernel runs the activation K6 runs
(``csrc/vocoder_common.cuh`` act_channel): one thread a channel and a run
of output rows, planned by ``launch_shape``.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import NamedTuple

import torch

from ..resample import (
    adaa_snake_beta, downsample_activation, snake_coefficients, upsample_activation)
from . import build, graphs
from .conv1d import check_f32, device_lengths

SOURCE = "miotts_tpu_torch/csrc/activation1d.cu"
REPLACES = "miotts_tpu/ops/pallas/activation1d.py:351"

# launches of the CUDA kernel in this process (the plain version and
# refusals do not count); callers may reset it to 0
launches = 0

_SMS = 132  # H100 SXM streaming multiprocessors
RUNS = (128, 32, 8, 1)  # output rows a thread, longest first
# the fill a run length must give: about one wave, the ~19 warps an SM that
# the kernel's 102 registers a thread let it hold, on 132 SMs
MIN_WARPS = 2560
BLOCK_WARPS = (4, 2, 1)  # warps a block, largest first


class ActGeom(NamedTuple):
    """csrc/vocoder_common.cuh act_geom: an Activation1d with k1 up and k2
    down taps; an output row t reads input rows [t - hlo, t + hhi]."""
    k1: int
    k2: int
    pad: int
    pl: int
    pl2: int
    hlo: int
    hhi: int


def act_geom(k1: int, k2: int) -> ActGeom:
    pad = k1 // 2 - 1
    pl = 2 * pad + (k1 - 2) // 2
    pl2 = k2 // 2 - (1 if k2 % 2 == 0 else 0)
    return ActGeom(k1, k2, pad, pl, pl2, pad - (pl - pl2 - k1) // 2, (k2 - 1 - pl2 + pl) // 2 - pad)


class Plan(NamedTuple):
    """One launch of csrc/activation1d.cu: each warp owns ``run`` output
    rows of 32 adjacent channels, ``warps`` warps a block, grid (blocks, B)."""
    run: int
    warps: int
    n_warps: int
    grid: tuple[int, int]


def launch_shape(B: int, T: int, C: int) -> Plan:
    """The longest run of RUNS whose warps (runs x 32-channel groups x B)
    reach MIN_WARPS, else the shortest; then the most warps a block that
    still give every SM a block, else one. (A sweep of run lengths and
    block sizes on the H100 found this plan the fastest of those tried at
    640, 5 120, 61 440 and 491 520 rows: scripts/bench_torch_k1_k5.py --sweep.)"""
    groups = math.ceil(C / 32)
    for run in RUNS:
        n_warps = math.ceil(T / run) * groups * B
        if n_warps >= MIN_WARPS or run == RUNS[-1]:
            break
    warps = next((w for w in BLOCK_WARPS if math.ceil(n_warps / B / w) * B >= _SMS), 1)
    return Plan(run, warps, n_warps, (math.ceil(math.ceil(T / run) * groups / warps), B))


_fn = None
_prepared: dict[tuple, tuple] = {}


def cached(key_tensors: tuple, make):
    """make(), computed once for these tensor objects while they are alive
    and unchanged (same objects, same versions), then kept. Refuses to fill
    an entry while a CUDA graph is being captured: run the graph's body once
    eagerly first (the codec and decode graphs' warm-up)."""
    key = tuple(map(id, key_tensors))
    versions = tuple(t._version for t in key_tensors)
    hit = _prepared.get(key)
    if hit is not None and hit[1] == versions and all(
            r() is t for r, t in zip(hit[0], key_tensors)):
        return hit[2]
    if graphs.capturing():
        raise RuntimeError("a kernel operand cache would fill during CUDA graph capture; "
                           "run the captured body once eagerly first")
    value = make()
    refs = tuple(weakref.ref(t, lambda _, k=key: _prepared.pop(k, None)) for t in key_tensors)
    _prepared[key] = (refs, versions, value)
    return value


def _entry():
    global _fn
    if _fn is None:
        fn = build.load_library().miotts_activation1d_f32
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def activation1d_plain(x, lengths, up_filter, alpha, beta, down_filter) -> torch.Tensor:
    """Plain PyTorch version, the JAX package's unfused composite: x [B, T, C]
    -> [B, T, C] (the up/down length arithmetic telescopes to the identity)."""
    y, ln = upsample_activation(x, lengths, up_filter)
    y = adaa_snake_beta(y, ln, alpha, beta)
    return downsample_activation(y, ln, down_filter)[0]


def activation_operands(act: dict, device: torch.device) -> tuple[torch.Tensor, ...]:
    """(fu, fd, a, inv) of one activation as the kernels take them: the
    filters and the snake coefficients a = e^alpha, inv = 1/(2(e^beta+1e-9)),
    contiguous f32 on ``device``."""
    a, inv = snake_coefficients(act["alpha"], act["beta"])
    return tuple(t.to(device=device, dtype=torch.float32).contiguous()
                 for t in (act["up_filter"], act["down_filter"], a, inv))


def check_act(act: dict, C: int, device: torch.device, what: str) -> None:
    fu, fd = act["up_filter"], act["down_filter"]
    if fu.dim() != 1 or fd.dim() != 1 or fu.shape[0] < 2 or fd.shape[0] < 1:
        raise ValueError(f"{what}: needs 1-D filters, up >= 2 taps; got up {list(fu.shape)}, "
                         f"down {list(fd.shape)}")
    for name in ("alpha", "beta"):
        if tuple(act[name].shape) != (C,) or act[name].device != device:
            raise ValueError(f"{what}: {name} must be [{C}] on {device}")


def activation1d(x, lengths, up_filter, alpha, beta, down_filter) -> torch.Tensor:
    """x [B, T, C] f32, lengths [B], 1-D filters (up >= 2 taps), alpha/beta
    [C] -> [B, T, C] f32, rows t >= length 0."""
    if x.device.type == "cpu":
        return activation1d_plain(x, lengths, up_filter, alpha, beta, down_filter)
    if x.device.type != "cuda":
        raise ValueError(f"activation1d: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"activation1d: x {list(x.shape)} must be [B, T, C]")
    B, T, C = x.shape
    if not 0 < B <= 65535 or T < 1 or T * C >= 2 ** 31:
        raise ValueError(f"activation1d: unsupported shape {list(x.shape)}")
    check_f32("x", x, (B, T, C), x.device, "activation1d")
    act = {"up_filter": up_filter, "down_filter": down_filter, "alpha": alpha, "beta": beta}
    check_act(act, C, x.device, "activation1d")
    fu, fd, a, inv = cached((up_filter, down_filter, alpha, beta),
                            lambda: activation_operands(act, x.device))
    lens = device_lengths(lengths, B, x.device)
    plan = launch_shape(B, T, C)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = build.launch(x.device, _entry(), x.data_ptr(), lens.data_ptr(), fu.data_ptr(),
                          fu.shape[0], fd.data_ptr(), fd.shape[0], a.data_ptr(), inv.data_ptr(),
                          out.data_ptr(), B, T, C, plan.run, plan.warps, stream)
    build.check(status, "activation1d")
    graphs.launched(__name__)
    return out
