"""Kernel K4: stride-1 'same' dilated conv1d in [B, T, C] layout, with the
bias, an optional residual and the length mask fused.

Wraps ``csrc/conv1d.cu`` (replaces the Pallas kernel
miotts_tpu/ops/pallas/conv1d.py::conv1d_same_pallas). A CPU tensor takes
the plain version; a CUDA tensor launches the kernel, or raises on anything
the kernel does not take.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..masking import mask_time
from ..resample import conv1d_zeropad
from . import build

SOURCE = "miotts_tpu_torch/csrc/conv1d.cu"
REPLACES = "miotts_tpu/ops/pallas/conv1d.py:144"

# launches of the CUDA kernel in this process (the plain version and
# refusals do not count); callers may reset it to 0
launches = 0

_SMS = 132  # H100 SXM streaming multiprocessors
# block tiles of csrc/conv1d.cu, largest first: (output rows, output columns)
TILES = ((128, 128), (64, 64), (16, 32))

_fn = None


def launch_shape(B: int, T: int, Cout: int) -> tuple[int, int, int, tuple[int, int, int]]:
    """(tile index, rows a block, columns a block, grid) for x [B, T, Cin]
    and Cout output channels: the largest tile of TILES whose grid gives
    every SM a block, else the smallest. Grid (ceil(T / rows), B,
    ceil(Cout / columns)); a block wholly past its example's length only
    zeroes its rows."""
    for i, (tm, tn) in enumerate(TILES):
        grid = (math.ceil(T / tm), B, math.ceil(Cout / tn))
        if math.prod(grid) >= _SMS or i == len(TILES) - 1:
            return i, tm, tn, grid
    raise AssertionError("unreachable")


def _entry():
    global _fn
    if _fn is None:
        fn = build.load_library().miotts_conv1d_same_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def conv1d_same_plain(x, lengths, w, b=None, dilation: int = 1, residual=None) -> torch.Tensor:
    """Plain PyTorch version: x [B, T, Cin] read as 0 at t >= length, w
    torch-layout [Cout, Cin, k] (odd k), padding d*(k-1)/2 a side; bias,
    then residual, then rows t >= length set to 0."""
    k = w.shape[-1]
    y = conv1d_zeropad(mask_time(x, lengths), w, b, dilation, dilation * (k - 1) // 2)
    if residual is not None:
        y = y + residual
    return mask_time(y, lengths)


def check_f32(name: str, t: torch.Tensor, shape: tuple, device: torch.device, what: str) -> None:
    """Raise unless ``t`` is a contiguous f32 tensor of ``shape`` on ``device``."""
    if (t.dtype != torch.float32 or t.device != device or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{what}: {name} must be contiguous f32 {list(shape)} on {device}, "
                         f"got {t.dtype} {list(t.shape)} on {t.device}")


def device_lengths(lengths: torch.Tensor, B: int, device: torch.device) -> torch.Tensor:
    """lengths as the kernels take them: contiguous int32 [B] on ``device``."""
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be [{B}], got {list(lengths.shape)}")
    return lengths.to(device=device, dtype=torch.int32).contiguous()


def conv1d_same(x, lengths, w, b=None, dilation: int = 1, residual=None) -> torch.Tensor:
    """x [B, T, Cin] f32, lengths [B], w [Cout, Cin, k] (odd k), b [Cout] or
    None, residual [B, T, Cout] or None -> [B, T, Cout] f32, rows t >= length 0."""
    global launches
    if x.device.type == "cpu":
        return conv1d_same_plain(x, lengths, w, b, dilation, residual)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_same: unsupported device {x.device}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"conv1d_same: x {list(x.shape)} must be [B, T, C], w {list(w.shape)} "
                         f"[Cout, Cin, k]")
    B, T, Cin = x.shape
    Cout, k = w.shape[0], w.shape[2]
    if (w.shape[1] != Cin or k % 2 == 0 or Cin % 4 or Cout % 4 or dilation < 1
            or not 0 < B <= 65535 or T < 1):
        raise ValueError(f"conv1d_same: x {list(x.shape)}, w {list(w.shape)}, dilation "
                         f"{dilation}: need w [Cout, Cin, k], odd k, Cin and Cout % 4 == 0")
    check_f32("x", x, (B, T, Cin), x.device, "conv1d_same")
    check_f32("w", w, (Cout, Cin, k), x.device, "conv1d_same")
    if b is not None:
        check_f32("b", b, (Cout,), x.device, "conv1d_same")
    if residual is not None:
        check_f32("residual", residual, (B, T, Cout), x.device, "conv1d_same")
    for name, t in (("x", x), ("b", b), ("residual", residual)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"conv1d_same: {name} must be 16-byte aligned")
    lens = device_lengths(lengths, B, x.device)
    w_kio = w.permute(2, 1, 0).contiguous()  # [k, Cin, Cout]
    out = torch.empty((B, T, Cout), dtype=torch.float32, device=x.device)
    tile = launch_shape(B, T, Cout)[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry()(x.data_ptr(), lens.data_ptr(), w_kio.data_ptr(),
                      None if b is None else b.data_ptr(),
                      None if residual is None else residual.data_ptr(), out.data_ptr(),
                      B, T, Cin, Cout, k, dilation, tile, stream)
    build.check(status, "conv1d_same")
    launches += 1
    return out
