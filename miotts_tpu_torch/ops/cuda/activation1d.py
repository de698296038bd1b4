"""Kernel K5: BigVGAN's anti-aliased snake activation (Activation1d) in
[B, T, C] layout: 2x upsample -> ADAA snake-beta -> 2x downsample, length
unchanged.

Wraps ``csrc/activation1d.cu`` (replaces the Pallas kernel
miotts_tpu/ops/pallas/activation1d.py::fused_activation1d). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel, or raises on
anything the kernel does not take.
"""

from __future__ import annotations

import ctypes

import torch

from ..resample import (
    adaa_snake_beta, downsample_activation, snake_coefficients, upsample_activation)
from . import build
from .conv1d import check_f32, device_lengths

SOURCE = "miotts_tpu_torch/csrc/activation1d.cu"
REPLACES = "miotts_tpu/ops/pallas/activation1d.py:351"

# launches of the CUDA kernel in this process (the plain version and
# refusals do not count); callers may reset it to 0
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load_library().miotts_activation1d_f32
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
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
    global launches
    if x.device.type == "cpu":
        return activation1d_plain(x, lengths, up_filter, alpha, beta, down_filter)
    if x.device.type != "cuda":
        raise ValueError(f"activation1d: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"activation1d: x {list(x.shape)} must be [B, T, C]")
    B, T, C = x.shape
    if not 0 < B <= 65535:
        raise ValueError(f"activation1d: unsupported batch {B}")
    check_f32("x", x, (B, T, C), x.device, "activation1d")
    act = {"up_filter": up_filter, "down_filter": down_filter, "alpha": alpha, "beta": beta}
    check_act(act, C, x.device, "activation1d")
    fu, fd, a, inv = activation_operands(act, x.device)
    lens = device_lengths(lengths, B, x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry()(x.data_ptr(), lens.data_ptr(), fu.data_ptr(), fu.shape[0], fd.data_ptr(),
                      fd.shape[0], a.data_ptr(), inv.data_ptr(), out.data_ptr(), B, T, C, stream)
    build.check(status, "activation1d")
    launches += 1
    return out
