"""The port's profiler hooks (miotts_tpu_torch/runtime/tracing.py, the
counterpart of miotts_tpu/runtime/tracing.py on torch.profiler): a set
MIOTTS_PROFILE_DIR leaves one Chrome trace a process, written when the
process ends normally, with the ``miocodec_synthesize`` phase of
``pipeline.synthesize`` and the phases of other threads; unset, nothing
starts and ``trace_phase`` does nothing. The span recorder: off, it reads
no clock; on, spans nest under their thread's open span or their request,
its ring drops and counts its oldest spans, device event pairs map onto
the host clock, the profiler's ranges keep their text, and
MIOTTS_SPAN_DIR leaves a Chrome trace."""

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
    env = {k: v for k, v in os.environ.items()
           if k not in ("MIOTTS_PROFILE_DIR", "MIOTTS_SPAN_DIR")}
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


# -- the span recorder ---------------------------------------------------------------

# the eight ranges a profiler's trace was read by before the recorder existed,
# as their callers open them, and the text each must keep there
PROFILED = [
    (("prefill_group",), dict(bucket=32, k=2, fused=1, rids=[5, 6]),
     "prefill_group bucket=32 k=2 fused=1"),
    (("attach",), dict(k=2, rids=[5, 6]), "attach k=2"),
    (("chunk_dispatch",), dict(steps=16, width=4, live=3, rids=[5, 6, 7]),
     "chunk_dispatch steps=16 width=4 live=3"),
    (("chunk_fetch",), dict(rids=[5]), "chunk_fetch"),
    (("chunk_deliver",), dict(rids=[5]), "chunk_deliver"),
    (("codec_group",), dict(B=2, bucket=64, rids=[5, 6], tags={"priority": 1}),
     "codec_group B=2 bucket=64"),
    (("miocodec_synthesize",), {}, "miocodec_synthesize"),
    (("reference_chain",), {}, "reference_chain"),
]


def _no_clock(*_a, **_k):
    raise AssertionError("read a clock")


def test_recorder_off_reads_no_clock(monkeypatch):
    """With the recorder off and no profiler, trace_phase (and the other
    entry points of the hot path) read no clock and hand back one shared
    no-op context: nothing is built."""
    assert not tracing.is_recording() and not torch.autograd._profiler_enabled()
    monkeypatch.setattr(tracing.time, "monotonic_ns", _no_clock)
    monkeypatch.setattr(tracing.time, "perf_counter", _no_clock)
    phases = [tracing.trace_phase(*a, **kw) for a, kw, _ in PROFILED]
    phases += [tracing.trace_phase("slot_wait", profiled=False), tracing.request_span(3),
               tracing.on_device()]
    assert all(p is phases[0] for p in phases)
    for p in phases:
        with p:
            pass
    assert tracing.now_ns() == 0
    tracing.record("codec_queue", 1, 2, rid=3)
    tracing.resolve_device()
    assert not tracing.is_recording()


def test_profiler_ranges_keep_their_text():
    """The eight ranges reach a profiler under their names and text, with
    the recorder on as well; request ids and tags stay out of the text, and
    a recorder-only span never reaches the profiler. The recorder keeps
    every attribute."""
    with tracing.recording() as rec:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for a, kw, _ in PROFILED:
                with tracing.trace_phase(*a, **kw):
                    torch.ones(2) + 1
            with tracing.trace_phase("slot_wait", profiled=False):
                torch.ones(2) + 1
    keys = {e.key for e in prof.key_averages()}
    assert {text for *_, text in PROFILED} <= keys
    assert not any(k.startswith("slot_wait") for k in keys)
    spans = {s.name: s for s in rec.collect()}
    assert set(spans) == {a[0] for a, *_ in PROFILED} | {"slot_wait"}
    assert spans["codec_group"].attrs == {"B": 2, "bucket": 64, "priority": 1}
    assert spans["codec_group"].rids == (5, 6)


def test_spans_nest_and_name_their_request():
    """A span's parent is its thread's innermost open span, else its
    request; it serves its parent's requests unless it names its own; a
    request's root span has the request's id as its own."""
    rid = tracing.new_id()
    with tracing.recording() as rec:
        with tracing.request_span(rid, route="/mio/tts"):
            with tracing.trace_phase("slot_wait", profiled=False):
                pass
        tracing.record("codec_queue", 10, 20, rid=rid, priority=0)
        with tracing.trace_phase("codec_group", B=1, bucket=32, rids=[rid]):
            pass
    spans = {s.name: s for s in rec.collect()}
    root = spans["request"]
    assert root.sid == rid and root.parent is None and root.rids == (rid,)
    assert spans["slot_wait"].parent == rid and spans["slot_wait"].rids == (rid,)
    assert spans["codec_queue"].parent == rid and spans["codec_queue"].start_ns == 10
    assert spans["codec_group"].parent is None and spans["codec_group"].rids == (rid,)
    assert all(s.end_ns >= s.start_ns for s in spans.values())
    assert not tracing.is_recording()


def test_ring_drops_its_oldest_spans_and_counts_them():
    with tracing.recording(capacity=4) as rec:
        for i in range(7):
            tracing.record(f"s{i}", i, i + 1)
    assert [s.name for s in rec.collect()] == ["s3", "s4", "s5", "s6"]
    assert rec.dropped == 3
    assert rec.collect() == []


def test_ring_under_threads_loses_no_count(monkeypatch):
    """Many threads recording at once, with a short switch interval: every
    span is either in the ring or counted as dropped."""
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording(capacity=1000) as rec:
            def work():
                for i in range(500):
                    with tracing.trace_phase("chunk_fetch", rids=[i]):
                        pass
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(rec.collect()) + rec.dropped == 16 * 500


class _FakeEvent:
    """A timing event at ``ms`` on a device's clock; ``done``: completed."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_device_intervals_map_through_the_anchor():
    """A completed event pair becomes a device span on the host's clock
    (anchor + the events' offsets from the anchor's event); one whose end
    has not completed waits, until ``wait`` resolves it."""
    rec = tracing.Recorder()
    rec._anchors = {0: (_FakeEvent(100.0), 5_000_000)}
    rec._pending = [
        ("device:chunk_dispatch", "cuda:0 stream 3", 42, (7,), {"steps": 16},
         0, _FakeEvent(101.0), _FakeEvent(103.5)),
        ("device:codec_group", "cuda:0 stream 5", 43, (8,), {}, 0, _FakeEvent(102.0),
         _FakeEvent(104.0, done=False)),
    ]
    rec.resolve()
    (s,) = rec.collect()
    assert (s.name, s.parent, s.rids, s.attrs) == ("device:chunk_dispatch", 42, (7,),
                                                   {"steps": 16})
    assert (s.start_ns, s.end_ns) == (6_000_000, 8_500_000)
    rec.resolve(wait=True)
    (s,) = rec.collect()
    assert s.name == "device:codec_group" and (s.start_ns, s.end_ns) == (7_000_000, 9_000_000)


def test_span_dir_writes_a_chrome_trace(tmp_path):
    """MIOTTS_SPAN_DIR switches the recorder on and leaves the process's
    spans as a Chrome trace at exit, one row a thread."""
    out = tmp_path / "spans"
    proc = _run(tmp_path, {"MIOTTS_SPAN_DIR": str(out)})
    assert proc.returncode == 0, proc.stderr
    (path,) = out.glob("miotts_*.spans.json")
    trace = json.loads(path.read_text())
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {"miocodec_synthesize", "phase_of_a_thread"} <= {e["name"] for e in spans}
    assert all(e["dur"] >= 0 and "sid" in e["args"] for e in spans)
    threads = {e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"}
    assert len(threads) >= 2
    assert trace["otherData"]["dropped"] == 0
    assert not list(tmp_path.rglob("*.pt.trace.json"))
