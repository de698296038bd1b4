"""The port never imports JAX: every miotts_tpu_torch module, and what
chip_smoke.py imports, load in a fresh interpreter with no ``jax`` in
sys.modules. Also the device rule: explicit, TF32 off, no CPU fallback."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from miotts_tpu_torch.device import select_device

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import miotts_tpu_torch
names = [m.name for m in pkgutil.walk_packages(miotts_tpu_torch.__path__, "miotts_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not bad, bad
print(len(names))
"""


def test_no_module_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15  # every module was walked


def test_select_device(monkeypatch):
    torch.backends.cudnn.allow_tf32 = True
    assert select_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")
    assert select_device() == torch.device("cpu")
    with pytest.raises(ValueError):
        select_device("tpu")


def test_cuda_is_never_silently_cpu(monkeypatch):
    monkeypatch.delenv("MIOTTS_PLATFORM", raising=False)
    if torch.cuda.is_available():
        assert select_device() == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError):
            select_device()  # the default is cuda
