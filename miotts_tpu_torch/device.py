"""Device selection (the port's counterpart of the JAX CLI's
``MIOTTS_PLATFORM``, miotts_tpu/cli.py:105-112).

``MIOTTS_PLATFORM=cuda|cpu`` picks the device; the default is ``cuda``.
Asking for CUDA where ``torch.cuda.is_available()`` is False raises: the
port never carries on quietly on the CPU.

The codec is held to f32 math (its fidelity bar is mel-L1 < 1e-2,
BASELINE.md:24). On the card a float32 convolution goes through cuDNN in
TF32 by default, so selecting a device turns both TF32 switches off.

``to_device`` and ``to_host`` move arrays through pinned host memory. A
copy from or to pageable memory is synchronous, and CUDA runs such
copies one at a time: in a server, one thread's read of a chunk result
(which waits for its chunk) would hold every other thread's small upload
until that chunk ends.
"""

from __future__ import annotations

import os

import numpy as np
import torch

PLATFORMS = ("cuda", "cpu")


def select_device(platform: str | None = None) -> torch.device:
    """Resolve ``platform`` (or ``MIOTTS_PLATFORM``, default ``cuda``) to a
    torch device, with TF32 off for matmuls and cuDNN convolutions."""
    if platform is None:
        platform = os.environ.get("MIOTTS_PLATFORM", "") or "cuda"
    platform = platform.lower()
    if platform not in PLATFORMS:
        raise ValueError(f"MIOTTS_PLATFORM must be one of {PLATFORMS}, got {platform!r}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("MIOTTS_PLATFORM=cuda but torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(platform)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; on CUDA an asynchronous copy from pinned
    memory on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host; from CUDA through pinned memory, after
    the current stream's work (not the whole card's) has run. The values
    come back in a copy of their own and the pinned buffer is freed here:
    PyTorch's pinned pool records an event on the copy's stream when a
    buffer is freed, and a buffer freed later, on another thread, would
    record it into any CUDA graph capture running on that stream then (a
    codec or reference graph's, whose captures and copies share a lock),
    which breaks the capture and every later pinned allocation."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy().copy()
