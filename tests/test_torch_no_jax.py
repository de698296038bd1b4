"""The port never imports JAX nor the JAX package: every miotts_tpu_torch
module (the C client bridge's among them), and what chip_smoke.py imports,
load in a fresh interpreter, which then decodes an mp3 reference natively,
with no ``jax`` and no ``miotts_tpu``/``miotts_tpu.*`` in sys.modules. Also
the device rule: explicit, TF32 off, no CPU fallback."""

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
from miotts_tpu_torch.runtime import audio_io, native
x, rate = audio_io.load_audio("tests/torch_assets/ref3.mp3")  # the mp3 route, native
assert rate == 24000 and x.size and native.calls["mio_mp3_decode"] == 1, native.calls
bad = sorted(m for m in sys.modules
             if m in ("jax", "miotts_tpu") or m.startswith(("jax.", "jaxlib", "miotts_tpu.")))
assert not bad, bad
print(" ".join(names))
"""


def test_no_module_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 46  # every module was walked, the serving slice's among them
    assert {"miotts_tpu_torch.streaming", "miotts_tpu_torch.models.decode_graph"} <= set(names)
    assert {f"miotts_tpu_torch.serving.{m}" for m in (
        "batching", "codec_batching", "engine", "server", "state", "webui")} <= set(names)
    assert {f"miotts_tpu_torch.converters.{m}" for m in (
        "miocodec", "wavlm", "preset_embedding", "quantize")} | {
        "miotts_tpu_torch.ops.precision"} <= set(names)
    assert {f"miotts_tpu_torch.parallel{m}"
            for m in ("", ".mesh", ".collectives", ".sequence")} <= set(names)
    assert {"miotts_tpu_torch.embed", "miotts_tpu_torch.models.wavlm",
            "miotts_tpu_torch.models.llm_cpu"} | {
        f"miotts_tpu_torch.runtime.{m}" for m in ("flac", "mp3", "mp3_tables", "llm_api",
                                                  "tracing", "device_dequant", "native",
                                                  "build_native")} <= set(names)
    assert {"miotts_tpu_torch.bindings", "miotts_tpu_torch.bindings.client",
            "miotts_tpu_torch.bindings.build_client"} <= set(names)


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
