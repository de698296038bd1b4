"""Kernel K6: one AMP resblock layer of the mel vocoder in one launch,
conv2(actB(conv1(actA(x), dilation))) + x, intermediates on chip.

Wraps ``csrc/resblock.cu`` (replaces the Pallas kernel
miotts_tpu/ops/pallas/resblock.py::fused_resblock_layer). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel, or raises on
anything the kernel does not take. Activations are dicts with ``alpha``,
``beta`` [C] and 1-D ``up_filter``/``down_filter``, as in the weight tree.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .activation1d import activation1d_plain, activation_operands, check_act
from .conv1d import check_f32, conv1d_same_plain, device_lengths

SOURCE = "miotts_tpu_torch/csrc/resblock.cu"
REPLACES = "miotts_tpu/ops/pallas/resblock.py:249"

# launches of the CUDA kernel in this process (the plain version and
# refusals do not count); callers may reset it to 0
launches = 0

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = build.load_library().miotts_resblock_layer_f32
        act = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_void_p]
        fn.argtypes = ([ctypes.c_void_p] * 2 + act + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + act + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
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
    global launches
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
    opsA = activation_operands(actA, x.device)
    opsB = activation_operands(actB, x.device)
    w1_kio, w2_kio = (w.permute(2, 1, 0).contiguous() for w in (w1, w2))  # [k, Cin, Cout]
    lens = device_lengths(lengths, B, x.device)
    out = torch.empty_like(x)

    def act_args(fu, fd, a, inv):
        return (fu.data_ptr(), fu.shape[0], fd.data_ptr(), fd.shape[0], a.data_ptr(),
                inv.data_ptr())

    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry()(x.data_ptr(), lens.data_ptr(), *act_args(*opsA), w1_kio.data_ptr(),
                      b1.data_ptr(), w1.shape[-1], dilation, *act_args(*opsB),
                      w2_kio.data_ptr(), b2.data_ptr(), w2.shape[-1], out.data_ptr(), B, T, C,
                      stream)
    build.check(status, "resblock_layer")
    launches += 1
    return out
