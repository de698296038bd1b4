"""Device selection (the port's counterpart of the JAX CLI's
``MIOTTS_PLATFORM``, miotts_tpu/cli.py:105-112).

``MIOTTS_PLATFORM=cuda|cpu`` picks the device; the default is ``cuda``.
Asking for CUDA where ``torch.cuda.is_available()`` is False raises: the
port never carries on quietly on the CPU.

The codec is held to f32 math (its fidelity bar is mel-L1 < 1e-2,
BASELINE.md:24). On the card a float32 convolution goes through cuDNN in
TF32 by default, so selecting a device turns both TF32 switches off.
"""

from __future__ import annotations

import os

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
