"""The port's profiler hooks (miotts_tpu_torch/runtime/tracing.py, the
counterpart of miotts_tpu/runtime/tracing.py on torch.profiler): a set
MIOTTS_PROFILE_DIR leaves one Chrome trace a process, written when the
process ends normally, with the ``miocodec_synthesize`` phase of
``pipeline.synthesize`` and the phases of other threads; unset, nothing
starts and ``trace_phase`` does nothing."""

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from miotts_tpu_torch.runtime import tracing

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = """
import threading
import numpy as np, torch
from miotts_tpu_torch.pipeline import MioTTSPipeline
from miotts_tpu_torch.runtime.tracing import trace_phase
from miotts_tpu_torch.testing import tiny_codec_config, write_synthetic_miocodec_gguf
cfg = tiny_codec_config()
write_synthetic_miocodec_gguf({codec!r}, cfg, seed=0)
pipe = MioTTSPipeline({codec!r}, torch.device("cpu"))
emb = np.random.RandomState(0).randn(cfg.decoder_adanorm_dim).astype(np.float32)
pipe.synthesize(list(range(20)), emb)
def work():
    with trace_phase("phase_of_a_thread"):
        torch.ones(4) + 1
t = threading.Thread(target=work)
t.start()
t.join()
print("done")
"""


def _run(tmp_path, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "MIOTTS_PROFILE_DIR"}
    env.update(PYTHONPATH=str(REPO), MIOTTS_PLATFORM="cpu", **env_extra)
    script = _SCRIPT.format(codec=str(tmp_path / "codec.gguf"))
    return subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_profile_dir_leaves_a_trace_at_exit(tmp_path):
    out = tmp_path / "prof"
    proc = _run(tmp_path, {"MIOTTS_PROFILE_DIR": str(out)})
    assert proc.returncode == 0, proc.stderr
    traces = list(out.glob("miotts_*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"miocodec_synthesize", "phase_of_a_thread"} <= names


def test_no_profile_dir_no_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("MIOTTS_PROFILE_DIR", raising=False)
    assert tracing.maybe_start_profiler() is False
    assert tracing.stop_profiler() is None
    with tracing.trace_phase("nothing"):
        assert not torch.autograd._profiler_enabled()
    proc = _run(tmp_path, {})
    assert proc.returncode == 0, proc.stderr
    assert not list(tmp_path.rglob("*.pt.trace.json"))


def test_trace_phase_in_a_callers_profiler():
    """trace_phase names a range in a profiler the calling thread runs."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.trace_phase("callers_phase"):
            torch.ones(3) * 2
    assert any(e.key == "callers_phase" for e in prof.key_averages())


def test_stop_profiler_writes_once(tmp_path, monkeypatch):
    monkeypatch.setenv("MIOTTS_PROFILE_DIR", str(tmp_path / "p"))
    assert tracing.maybe_start_profiler() and tracing.maybe_start_profiler()
    with tracing.trace_phase("in_process_phase"):
        torch.ones(3) + 1
    path = tracing.stop_profiler()
    assert path == str(tmp_path / "p" / f"miotts_{os.getpid()}.pt.trace.json")
    names = {e.get("name") for e in json.loads(Path(path).read_text())["traceEvents"]}
    assert "in_process_phase" in names
    assert tracing.stop_profiler() is None
