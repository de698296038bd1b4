"""The harness: one cell's server in this process, windows of open-loop
load from a child process, and what a window leaves to read.

``Bench`` finds everything by name in ``BENCHMARK.json``: the cell's
configuration (``configs/<name>.json``), its traffic mix
(``workloads/<traffic>.json``), its rate and limits (``cells/<cell>.json``)
and its metrics (``metrics/<metric>.py``, each a ``read(window)``).
``setup`` writes the weights from the seed, builds the port's server from
its own argument parser (``miotts_tpu_torch.serving.server``, as its
``main`` does), starts it on a free port and waits until ``/mio/health``
says the warm-up is complete. ``window`` sends a schedule and returns a
``Window``: every request's record (seconds from the window's opening),
the codec graph counters at the opening and the close, and, traced, the
profiler's record of a span inside the window (``traced_slice``: a short
window of the cell's own schedule after the timed one).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import torch

from . import trace as trace_mod
from . import weights
from .tokenizer import Tokenizer
from .traffic import Request, sample, schedule

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
BANNED = frozenset({"jax", "jaxlib", "flax", "miotts_tpu"})
# The traced slice: TRACE_SLICE_S of the cell's own open-loop schedule, at
# its own rate, sent once the window has drained. The profiler starts before
# it and stops after its last answer, the server idle both times (started
# under load it took ~12 s, stopped under load it hung the process). The span
# read is TRACE_SECONDS from TRACE_AT_S: past the slice's first second, once
# its arrivals hold about as many lanes as the window's steady state does.
TRACE_SLICE_S = 2.5
TRACE_AT_S = 1.0
TRACE_SECONDS = 1.5


def banned_modules(modules=None) -> list[str]:
    """Top-level names (before the first dot, compared whole) of loaded
    modules that the harness must never load."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & BANNED)


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def metric_reader(name: str):
    """The ``read`` of ``metrics/<name>.py``; a name with no file of its own
    reads as the name before its last dot (``latency_p50_ms.mel`` as
    ``latency_p50_ms``): the same quantity under a cell's own name and
    bound."""
    stem = name
    while not (PKG / "metrics" / f"{stem}.py").exists():
        if "." not in stem:
            raise FileNotFoundError(f"no reader for metric {name!r} in {PKG / 'metrics'}")
        stem = stem.rsplit(".", 1)[0]
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{stem}",
                                                  PKG / "metrics" / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Window:
    """What one window left: ``records`` by request index (times in
    seconds from the opening), ``codec``: the codec graph counters at the
    opening and the close, ``trace``: the traced span (or None) and where it
    lay in the window."""
    seconds: float
    requests: list[Request]
    records: dict[int, dict]
    codec: tuple[dict, dict]
    trace: trace_mod.Trace | None
    trace_window: tuple[float, float] | None
    loadgen: dict
    prompt_tokens: dict[int, int]
    cfg: dict
    mix: dict
    sample_rate: int
    setup_s: float | None = None
    trace_read_s: float | None = None  # stopping the profiler and reading the trace
    traced: "Window | None" = None  # a traced run's traced slice (``Bench.traced_slice``)

    @property
    def attempted(self) -> int:
        return len(self.requests)

    @property
    def ok(self) -> list[dict]:
        return [r for r in self.records.values() if r.get("ok")]


class Bench:
    def __init__(self, workload: str, root: Path = ROOT, mix: dict | None = None,
                 params: dict | None = None):
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"perfbench: no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        conf = next(c for c in bench["configs"] if c["name"] == self.cell["config"])
        self.cfg = load_json(root / conf["file"])
        self.mix = mix or load_json(PKG / "workloads" / f"{self.cell['traffic']}.json")
        self.params = params or load_json(PKG / "cells" / f"{workload}.json")

        def mine(m):
            return workload in m.get("workloads", [workload])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]
        self.srv = None
        self.extra_flags: list[str] = []  # the controls' own (control.py), after the cell's
        self.paths: dict[str, Path] = {}
        tokens, types = weights.synthetic_vocab(self.cfg["llm"]["n_audio"],
                                                self.cfg["llm"]["n_filler_vocab"])
        self.tok = Tokenizer(tokens, [], types)
        self.n_windows = 0

    def setup(self, run_dir: Path, seed: int, device: torch.device) -> None:
        from miotts_tpu_torch.serving import server as server_mod

        self.run_dir = run_dir
        self.paths = weights.write_all(run_dir / "weights", self.cfg, seed, device)
        argv = self.server_argv(run_dir, self.paths)
        cfg = server_mod.config_from_args(server_mod.build_arg_parser().parse_args(argv))
        self.srv = server_mod.MioTTSServer(cfg, device)
        self.srv.start_background()
        while not self.health().get("warmup_complete"):
            time.sleep(0.05)
        self.sample_rate = self.srv.engine.pipeline.sample_rate

    def server_argv(self, run_dir: Path, paths: dict) -> list[str]:
        """The server's flags: the weights and the WAVs under ``run_dir``, a
        free port, the configuration's own flags."""
        return ["-mv", str(paths["codec"]), "-m", str(paths["llm"]),
                "--host", "127.0.0.1", "--port", "0", "--output-dir", str(run_dir / "wav"),
                "--reference-file", json.dumps({"key": "voice", "path": str(paths["voice"])}),
                *self.cfg["server_flags"], *self.extra_flags]

    def health(self) -> dict:
        url = f"http://127.0.0.1:{self.srv.port}/mio/health"
        with urllib.request.urlopen(url, timeout=30) as r:
            return json.loads(r.read())

    @staticmethod
    def codec_counters() -> dict:
        from miotts_tpu_torch.models import codec_graph

        return dataclasses.asdict(codec_graph.codec)

    def window(self, reqs: list[Request], seconds: float, keep: set[int] = frozenset(),
               traced: bool = False, lead_s: float = 1.0) -> Window:
        """Send ``reqs`` (due offsets within ``seconds``), wait for every
        answer, and return the window's records."""
        self.n_windows += 1
        out = self.run_dir / f"window{self.n_windows}"
        keep_dir = out / "keep"
        keep_dir.mkdir(parents=True, exist_ok=True)
        specs = []
        for r in reqs:
            body = r.body(self.mix)
            if not r.stream:
                body["codes_out"] = str(keep_dir / f"{r.i}.codes")
            specs.append({"i": r.i, "due_s": r.due_s, "stream": r.stream, "body": body,
                          "keep": r.i in keep})
        if traced:
            self._profile_on()
        start_at = time.monotonic() + lead_s
        setup_s = process_age_s() + lead_s  # the process's age when the window opens
        spec = {"host": "127.0.0.1", "port": self.srv.port, "start_at": start_at,
                "requests": specs, "out_dir": str(out),
                "timeout_s": self.mix["request_timeout_s"]}
        spec_path = out / "spec.json"
        spec_path.write_text(json.dumps(spec))
        proc = subprocess.Popen([sys.executable, "-m", "perfbench.loadgen", str(spec_path)],
                                cwd=str(PKG.parent))
        tr = tw = None
        try:
            codec0 = self._at(start_at, self.codec_counters)
            if traced:
                tw = self._trace_span(start_at)
            codec1 = self._at(start_at + seconds, self.codec_counters)
            proc.wait(timeout=seconds + self.mix["request_timeout_s"] + 60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if traced:
                t0 = time.monotonic()
                tr = self._trace_read()
                read_s = time.monotonic() - t0
        records = {}
        for line in (out / "records.jsonl").read_text().splitlines():
            rec = json.loads(line)
            for k in ("due", "sent", "first_audio", "done"):
                if k in rec:
                    rec[k] -= start_at
            rec["audio_events"] = [[t - start_at, n] for t, n in rec.get("audio_events", [])]
            records[rec["i"]] = rec
        return Window(seconds, reqs, records, (codec0, codec1), tr, tw,
                      load_json(out / "loadgen.json"),
                      {r.i: len(self.tok.prompt_ids(r.text)) for r in reqs}, self.cfg, self.mix,
                      self.sample_rate, setup_s, read_s if traced else None)

    @staticmethod
    def _at(t: float, fn):
        time.sleep(max(0.0, t - time.monotonic()))
        return fn()

    def _profile_on(self) -> None:
        """Start the port's profiler (``runtime/tracing.py``: every thread,
        every kernel) while the server is idle: started under load it took
        ~12 s, and stopped under load it hung the process."""
        from miotts_tpu_torch.runtime import tracing

        os.environ["MIOTTS_PROFILE_DIR"] = str(self.run_dir / "trace")
        try:
            tracing.maybe_start_profiler()
        finally:
            del os.environ["MIOTTS_PROFILE_DIR"]  # no other thread may start a second one

    @staticmethod
    def _trace_span(start_at: float) -> tuple[float, float]:
        """Mark TRACE_SECONDS from TRACE_AT_S after the opening with a
        ``SPAN`` range; returns them in window seconds."""
        from miotts_tpu_torch.runtime import tracing

        time.sleep(max(0.0, start_at + TRACE_AT_S - time.monotonic()))
        a = time.monotonic()
        with tracing.trace_phase(trace_mod.SPAN):
            time.sleep(TRACE_SECONDS)
        return a - start_at, time.monotonic() - start_at

    @staticmethod
    def _trace_read() -> trace_mod.Trace | None:
        """Stop the profiler (the server idle), read the span back and
        delete the trace."""
        from miotts_tpu_torch.runtime import tracing

        path = tracing.stop_profiler()
        if not path:
            return None
        try:
            return trace_mod.load(Path(path))
        finally:
            Path(path).unlink()

    def close(self) -> None:
        """Stop the server and free what it held on the device."""
        if self.srv is not None:
            self.srv.shutdown()
            self.srv = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def traced_slice(self, seed: int) -> Window:
        """The traced slice: TRACE_SLICE_S of the cell's schedule at its
        rate, drawn with ``seed``, profiled (``_trace_span``)."""
        return self.window(self.schedule(seed, TRACE_SLICE_S), TRACE_SLICE_S, traced=True)

    # -- one run ------------------------------------------------------------------

    def schedule(self, seed: int, seconds: float, rate: float | None = None) -> list[Request]:
        return schedule(self.mix, self.params["rate_rps"] if rate is None else rate, seconds,
                        seed)

    def sample(self, reqs: list[Request], seed: int) -> dict[str, list[int]]:
        return sample(reqs, seed, self.mix["check"])
