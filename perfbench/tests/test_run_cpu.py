"""Whole runs on the CPU at a tiny size: the harness past its look for a
card, the port's server, the load generator and the reference. A sound run
is correct; a run with its timed path broken is not (a token altered where
it is produced, a decode step that leaves the KV cache as it was, the audio
altered where it is produced)."""

import json

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.tests.tiny import LIMITS, tiny_bench


def cpu_run(tmp_path, config="tiny_wave", faults=None, trace=0, seed=2**31 + 7):
    b = tiny_bench(tmp_path / "root", config)
    args = run.parse(["--workload", "tiny.open", "--seed", str(seed), "--seconds", "3",
                      "--trace", str(trace)])
    return run.run(args, torch.device("cpu"), b, tmp_path / "run", faults=faults)


@pytest.mark.parametrize("config", ["tiny_wave", "tiny_mel"])
def test_sound_run_is_correct(tmp_path, config):
    res = cpu_run(tmp_path, config)
    line = json.loads(json.dumps(res))  # what main prints
    assert list(line)[:3] == ["correct", "attempted", "failed"] and list(line)[-1] == "check"
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "check"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] == 6
    assert set(line["metrics"]) == {"latency_p50_ms", "latency_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["check"]) == set(LIMITS)
    assert all(c["value"] <= c["limit"] for c in line["check"].values())


def test_traced_run_reports_per_layer_metrics(tmp_path):
    res = cpu_run(tmp_path, trace=1)
    assert res["correct"] is True
    assert {"ttfa_p50_ms", "ttfa_p95_ms", "engine.wait_ms_mean", "codec.cold_decodes"} <= set(
        res["metrics"])
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def alter_tokens(bench):
    b = bench.srv.engine.batcher
    real = b._deliver_chunk
    audio = min(bench.srv.engine.llm.token_to_code)

    def deliver(out_np, n_np, done_np, snapshot):
        out_np = np.array(out_np)
        out_np[:, 0] = audio
        return real(out_np, n_np, done_np, snapshot)
    b._deliver_chunk = deliver


def stale_cache(bench):
    from miotts_tpu_torch.models import llm

    real = llm.llm_decode_step

    def step(cfg, w, token, pos, cache_k, cache_v):
        saved = (cache_k.clone(), cache_v.clone())
        out = real(cfg, w, token, pos, cache_k, cache_v)
        cache_k.copy_(saved[0])
        cache_v.copy_(saved[1])
        return out
    bench.faults_undo = lambda: setattr(llm, "llm_decode_step", real)
    llm.llm_decode_step = step


def alter_audio(bench):
    cb = bench.srv.engine.codec_batcher
    real = cb.synthesize

    def synthesize(*a, **k):
        res = real(*a, **k)
        res.audio[: res.audio.size // 2] = res.audio[: res.audio.size // 2] // 2
        return res
    cb.synthesize = synthesize


@pytest.mark.parametrize("fault,fails", [(alter_tokens, "llm_gap"), (stale_cache, "llm_gap"),
                                         (alter_audio, "wav_err")])
def test_broken_path_is_not_correct(tmp_path, fault, fails):
    holder = {}

    def apply(bench):
        fault(bench)
        holder["bench"] = bench
    try:
        res = cpu_run(tmp_path, faults=apply)
    finally:
        undo = getattr(holder.get("bench"), "faults_undo", None)
        if undo:
            undo()
    assert res["correct"] is False
    v = res["check"][fails]["value"]
    assert v is None or v > res["check"][fails]["limit"]
