"""The port's HTTP server (miotts_tpu_torch/serving/server.py) on the CPU:
the cases of tests/test_server.py that need no WavLM, external LLM or
device mesh, a probe table run against both the JAX and the port server
(status code, JSON keys and error text equal), and inline-codes audio
against the JAX server's (within 4 PCM16 steps)."""

import base64
import concurrent.futures
import json
import os
import queue
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from miotts_tpu.serving.server import MioTTSServer as JaxServer
from miotts_tpu.serving.state import ServerConfig as JaxServerConfig
from miotts_tpu_torch.gguf.writer import save_embedding_gguf
from miotts_tpu_torch.runtime import tracing
from miotts_tpu_torch.serving import server as server_mod
from miotts_tpu_torch.serving.engine import ServingEngine, SlotPool
from miotts_tpu_torch.serving.server import MioTTSServer, _parse_multipart, build_arg_parser
from miotts_tpu_torch.serving.state import RequestError, ServerConfig, parse_request_json
from miotts_tpu_torch.testing import (
    tiny_codec_config, write_synthetic_llm_gguf, write_synthetic_miocodec_gguf)

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


def _assets(d: Path):
    cfg_codec = tiny_codec_config()
    write_synthetic_miocodec_gguf(str(d / "codec.gguf"), cfg_codec, seed=0)
    write_synthetic_llm_gguf(str(d / "llm.gguf"), n_audio=cfg_codec.vocab_size, seed=1,
                             audio_logit_scale=3.0)
    save_embedding_gguf(d / "voice.emb.gguf",
                        np.random.RandomState(0).randn(cfg_codec.decoder_adanorm_dim)
                        .astype(np.float32))
    return cfg_codec


def _config(cls, d: Path, model: str, **kw):
    kw = {"n_parallel": 2, "n_predict": 32, "n_ctx": 128, **kw}
    return cls(model_vocoder=str(d / "codec.gguf"), model=model, host="127.0.0.1", port=0,
               output_dir=str(d / "out"), reference_added_output_dir=str(d / "refs"),
               reference_file_json=json.dumps({"key": "preset",
                                               "path": str(d / "voice.emb.gguf")}), **kw)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    d = tmp_path_factory.mktemp("srv")
    cfg_codec = _assets(d)
    srv = MioTTSServer(_config(ServerConfig, d, str(d / "llm.gguf")), CPU)
    srv.start_background()
    yield srv, d, d / "voice.emb.gguf", cfg_codec
    srv.shutdown()


@pytest.fixture(scope="module")
def jax_server(server):
    """The JAX server on the same codec (no LLM: the probes need none)."""
    _, d, *_ = server
    srv = JaxServer(_config(JaxServerConfig, d, ""))
    srv.start_background()
    yield srv
    srv.shutdown()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def _post_json(srv, path, obj, headers=None):
    req = urllib.request.Request(_url(srv, path), data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=120)


def _parse_sse(body: str):
    events, order = {}, []
    for block in body.strip().split("\n\n"):
        lines = block.split("\n")
        ev = next((l[7:] for l in lines if l.startswith("event: ")), None)
        data = next((l[6:] for l in lines if l.startswith("data: ")), None)
        if ev:
            events.setdefault(ev, []).append(data)
            order.append(ev)
    return events, order


def test_health(server):
    srv, *_ = server
    with urllib.request.urlopen(_url(srv, "/mio/health"), timeout=30) as r:
        j = json.loads(r.read())
    assert j["status"] == "ok" and j["parallel"] == 2
    assert j["reference_generation_enabled"] is False
    assert j["reference_cache"] >= 1 and j["warmup_complete"] is True
    assert j["device_stalled"] is False and j["backend_devices"] == 1
    assert "llm_shared_context" in j and "external_llm_enabled" in j


def test_references_list(server):
    srv, *_ = server
    with urllib.request.urlopen(_url(srv, "/mio/references"), timeout=30) as r:
        j = json.loads(r.read())
    assert j["ok"] is True and "preset" in [e["key"] for e in j["references"]]


def test_tts_with_inline_codes(server):
    srv, *_ = server
    with _post_json(srv, "/mio/tts", {"codes": list(range(24)), "reference_key": "preset"}) as r:
        j = json.loads(r.read())
    assert j["ok"] is True and j["mode"] == "synthesis" and j["codes"] == 24
    assert j["sample_rate"] == 24000 and j["n_audio"] > 0
    assert j["output_file"].endswith(".wav") and "slot" in j
    assert Path(j["output_file"]).read_bytes()[:4] == b"RIFF"


def test_tts_stream_binary(server):
    srv, *_ = server
    with _post_json(srv, "/mio/tts/stream",
                    {"codes": [1, 2, 3, 4, 5, 6, 7, 8], "reference_key": "preset"}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        assert r.headers["X-Reference-Key"] == "preset"
        assert int(r.headers["X-Sample-Rate"]) == 24000
        data = r.read()
    assert data[:4] == b"RIFF"
    assert int(r.headers["X-Audio-Samples"]) * 2 + 44 == len(data)


def test_tts_text_via_llm(server):
    srv, *_ = server
    with _post_json(srv, "/v1/audio/speech",
                    {"text": "hello world", "reference_key": "preset", "n_predict": 16}) as r:
        j = json.loads(r.read())
    assert j["ok"] is True and j["codes"] > 0 and "llm_ms" in j


def test_tts_sse_stream_tokens(server):
    srv, *_ = server
    with _post_json(srv, "/mio/tts/stream", {"text": "hi", "reference_key": "preset",
                                             "stream_tokens": True, "n_predict": 12}) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        events, order = _parse_sse(r.read().decode())
    tok0 = json.loads(events["token"][0])
    assert "id" in tok0 and tok0["i"] == 0
    gc = json.loads(events["generation_complete"][0])
    assert gc["n_codes"] > 0 and "llm_ms" in gc
    meta = json.loads(events["audio_meta"][0])
    assert meta["sample_rate"] == 24000 and meta["wav_size"] > 44
    wav = base64.b64decode(events["audio_data"][0])
    assert wav[:4] == b"RIFF" and len(wav) == meta["wav_size"]
    assert (order.index("generation_complete") < order.index("audio_meta")
            < order.index("audio_data"))


def test_codes_only(server):
    srv, *_ = server
    with _post_json(srv, "/mio/tts", {"codes": [5, 6, 7], "codes_only": True,
                                      "reference_key": "preset"}) as r:
        j = json.loads(r.read())
    assert j["ok"] is True and j["mode"] == "codes-only" and j["codes_values"] == [5, 6, 7]


def test_add_and_delete_reference(server):
    srv, d, emb_path, cfg_codec = server
    with _post_json(srv, "/mio/add_reference", {"key": "added1", "path": str(emb_path)}) as r:
        j = json.loads(r.read())
    assert j["ok"] is True and j["mode"] == "add-reference"
    assert j["embedding_dim"] == cfg_codec.decoder_adanorm_dim
    assert (d / "refs" / "added1.emb.gguf").exists()
    with _post_json(srv, "/mio/delete_reference", {"key": "added1"}) as r:
        j = json.loads(r.read())
    assert j["ok"] is True and j["removed"] is True and j["removed_saved_file"] is True
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_json(srv, "/mio/delete_reference", {"key": "added1"})
    assert ei.value.code == 404


def test_delete_reference_restful_alias(server):
    srv, d, emb_path, _ = server
    _post_json(srv, "/mio/add_reference", {"reference_key": "rest_del",
                                           "path": str(emb_path)}).read()
    req = urllib.request.Request(_url(srv, "/mio/references/rest_del"), method="DELETE")
    with urllib.request.urlopen(req, timeout=30) as r:
        j = json.loads(r.read())
    assert j["ok"] and j["reference_key"] == "rest_del" and j["removed"]
    for path in ("/mio/references/rest_del", "/mio/unknown/shape"):
        req = urllib.request.Request(_url(srv, path), method="DELETE")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 404


def test_parallel_requests(server):
    srv, *_ = server

    def one(i):
        with _post_json(srv, "/mio/tts", {"codes": list(range(8 + i)),
                                          "reference_key": "preset"}) as r:
            return json.loads(r.read())

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        results = list(ex.map(one, range(6)))
    assert all(j["ok"] for j in results)
    assert {j["slot"] for j in results} <= {0, 1}


def test_connect_burst_not_refused(server):
    srv, *_ = server
    assert srv.httpd.request_queue_size >= 64
    barrier = threading.Barrier(64)

    def one(i):
        barrier.wait()
        with urllib.request.urlopen(_url(srv, "/mio/health"), timeout=60) as r:
            return json.loads(r.read())["status"]

    with concurrent.futures.ThreadPoolExecutor(64) as ex:
        assert list(ex.map(one, range(64))) == ["ok"] * 64


def test_multipart_binary_payload_with_crlf_tail():
    payload = bytes(range(256)) + b"\n\r\n"
    boundary = "XYZ"
    body = (f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="audio"; filename="a.bin"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n").encode()
    body += payload + f"\r\n--{boundary}--\r\n".encode()
    fields, files = _parse_multipart(f"multipart/form-data; boundary={boundary}", body)
    assert files["audio"][1] == payload


def test_web_ui_assets(server):
    srv, *_ = server
    with urllib.request.urlopen(_url(srv, "/"), timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/html")
        page = r.read().decode()
    assert "/mio-ui.css" in page and "/mio-ui.js" in page
    for elem in ("btn-generate", "btn-gen-ref", "btn-add-ref", "ref-select", "p-n-predict"):
        assert elem in page, elem
    with urllib.request.urlopen(_url(srv, "/mio-ui.css"), timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/css") and len(r.read()) > 100
    with urllib.request.urlopen(_url(srv, "/mio-ui.js"), timeout=30) as r:
        assert r.headers["Content-Type"].startswith("application/javascript")
        assert "/mio/tts/stream" in r.read().decode()


def test_metrics_endpoint(server):
    srv, *_ = server
    with _post_json(srv, "/mio/tts/stream", {"codes": [1, 2, 3, 4],
                                             "reference_key": "preset"}) as r:
        r.read()
    with urllib.request.urlopen(_url(srv, "/metrics"), timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode()
    lines = dict(l.split(" ", 1) for l in body.splitlines() if l and not l.startswith("#"))
    assert float(lines["miotts_requests_total"]) >= 1
    assert float(lines["miotts_audio_seconds_total"]) > 0
    assert float(lines["miotts_inflight"]) == 0
    assert float(lines["miotts_device_stall_events_total"]) == 0
    assert "miotts_longest_chunk_fetch_seconds" in lines


def _metrics(srv) -> dict[str, float]:
    with urllib.request.urlopen(_url(srv, "/metrics"), timeout=30) as r:
        body = r.read().decode()
    return {k: float(v) for k, v in (l.split(" ", 1) for l in body.splitlines()
                                     if l and not l.startswith("#"))}


def test_metrics_count_codec_decodes_widths_and_waits(server):
    """/metrics exposes the codec graph counters, the batcher's chunks by
    width and attach holds, the fused decode kernels' launches, and the
    sums and counts of the codec queue's and the submit-to-attach waits:
    one text request adds one attach wait, at least one codec call and one
    chunk."""
    srv, *_ = server
    before = _metrics(srv)
    with _post_json(srv, "/mio/tts", {"text": "count me", "reference_key": "preset"}) as r:
        assert json.loads(r.read())["ok"]
    after = _metrics(srv)
    for name in ("miotts_codec_graph_replays_total", "miotts_codec_eager_decodes_total",
                 "miotts_codec_graph_captures_total"):
        assert after[name] == 0  # the CPU decodes eagerly, outside the graph counters
    assert "miotts_batcher_attach_holds_total" in after
    wait = "miotts_batcher_attach_wait_seconds"
    assert after[f"{wait}_count"] == before[f"{wait}_count"] + 1
    assert after[f"{wait}_sum"] > before[f"{wait}_sum"]
    queue = "miotts_codec_queue_seconds"
    assert after[f"{queue}_count"] >= before[f"{queue}_count"] + 1
    assert after[f"{queue}_sum"] > before[f"{queue}_sum"]

    def chunks(m):
        return sum(v for k, v in m.items() if k.startswith('miotts_batcher_chunks_total{width="'))
    assert chunks(after) >= chunks(before) + 1
    # the fused kernels' counters: the CPU runs their plain versions, no launch
    for kernel in ("add_rms_norm", "qkv_rope_cache", "silu_mul", "sample_step", "norm_qkv",
                   "gemv_residual", "norm_gateup", "norm_head"):
        name = f'miotts_llm_fused_launches_total{{kernel="{kernel}"}}'
        assert after[name] == before[name]


# spans every synthesis request of text leaves, each caused by its request
REQUEST_SPANS = {"slot_wait", "lane_wait", "prefill_queue", "attach_wait", "codec_queue",
                 "respond"}


@pytest.mark.parametrize("stream", [False, True], ids=["tts", "sse"])
def test_a_request_is_one_span_tree(server, stream):
    """With the recorder on, one /mio/tts request, or one SSE stream with
    its audio, is one tree under one request id: its root ``request`` and
    every per-request span name it as parent; the prefill group, the
    attach, the chunks and the codec groups that served it list it."""
    srv, *_ = server
    body = {"text": "a traced request", "reference_key": "preset", "n_predict": 32}
    if stream:
        body.update(stream_tokens=True, stream_audio=True)
    spans = []
    with tracing.recording() as rec:
        with _post_json(srv, "/mio/tts/stream" if stream else "/mio/tts", body) as r:
            answer = r.read().decode()
        deadline = time.monotonic() + 30  # the handler closes its root span after the answer
        while time.monotonic() < deadline:
            spans += rec.collect()
            if any(s.name == "request" for s in spans):
                break
            time.sleep(0.01)
    spans += rec.collect()
    (root,) = [s for s in spans if s.name == "request"]
    rid = root.sid
    assert root.rids == (rid,) and root.parent is None
    mine = [s for s in spans if rid in s.rids]
    names = {s.name for s in mine}
    assert REQUEST_SPANS <= names
    assert {"prefill_group", "attach", "chunk_dispatch", "chunk_fetch", "chunk_deliver",
            "codec_group"} <= names
    assert all(s.parent == rid for s in mine if s.name in REQUEST_SPANS)
    assert all(s.end_ns >= s.start_ns for s in spans)
    assert all(root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
               for s in mine if s.name in REQUEST_SPANS)
    n_audio = len(_parse_sse(answer)[0].get("audio_chunk", [])) if stream else 1
    assert sum(s.name == "respond" for s in mine) == n_audio  # each audio write (the WAV's)
    if stream:  # the stream's first decode is a priority one
        assert any(s.name == "codec_group" and s.attrs["priority"] for s in mine)


def test_profiler_ranges_of_a_served_request_keep_their_text(server, tmp_path, monkeypatch):
    """The batcher's and the codec's ranges reach the module's profiler
    (every thread) from their real call sites with the text a trace was
    read by before the recorder existed: a fixed name, then key=value of
    the same attributes, no request ids or tags; the recorder-only spans
    stay out."""
    import re

    srv, *_ = server
    monkeypatch.setenv("MIOTTS_PROFILE_DIR", str(tmp_path / "prof"))
    assert tracing.maybe_start_profiler()
    try:
        with _post_json(srv, "/mio/tts/stream", {"text": "profiled", "reference_key": "preset",
                                                 "stream_tokens": True,
                                                 "stream_audio": True}) as r:
            r.read()
    finally:
        path = tracing.stop_profiler()
    names = {e.get("name", "") for e in json.loads(Path(path).read_text())["traceEvents"]}
    patterns = [r"prefill_group bucket=\d+ k=\d+ fused=[01]", r"attach k=\d+",
                r"chunk_dispatch steps=\d+ width=\d+ live=\d+", r"chunk_fetch", r"chunk_deliver",
                r"codec_group B=\d+ bucket=\d+"]
    for pat in patterns:
        assert any(re.fullmatch(pat, n) for n in names), pat
    first = {n.split(" ", 1)[0] for n in names}
    assert not first & (REQUEST_SPANS | {"request"})
    assert not any("rids" in n or "priority" in n for n in names)


def test_slot_pool_timeout_503():
    pool = SlotPool(2)
    a, b = pool.acquire(), pool.acquire()
    with pytest.raises(RequestError) as ei:
        pool.acquire(timeout=0.05)
    assert ei.value.code == 503
    pool.release(a)
    assert pool.acquire(timeout=1.0) == a
    pool.release(b)


def test_tts_sse_stream_audio(server):
    """stream_audio on the SSE path: audio_chunk events arrive before
    generation completes and reassemble to n_audio samples."""
    srv, *_ = server
    with _post_json(srv, "/mio/tts/stream", {"text": "x", "reference_key": "preset",
                                             "stream_tokens": True, "stream_audio": True,
                                             "n_predict": 48}) as r:
        events, order = _parse_sse(r.read().decode())
    assert "audio_chunk" in events, order
    assert order.index("audio_chunk") < order.index("generation_complete")
    meta = json.loads(events["audio_meta"][0])
    assert meta["streamed"] is True and meta["sample_rate"] == 24000
    total = 0
    for i, raw in enumerate(events["audio_chunk"]):
        c = json.loads(raw)
        assert c["seq"] == i and len(base64.b64decode(c["pcm16"])) == 2 * c["n_samples"]
        total += c["n_samples"]
    assert total == meta["n_audio"] > 0
    assert "audio_data" not in events


def test_tts_binary_stream_audio(server):
    srv, *_ = server
    with _post_json(srv, "/mio/tts/stream", {"text": "hello binary stream",
                                             "reference_key": "preset", "stream_audio": True,
                                             "n_predict": 24}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        assert r.headers["X-Audio-Streaming"] == "1"
        data = r.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    assert struct.unpack_from("<I", data, 4)[0] == struct.unpack_from("<I", data, 40)[0] \
        == 0xFFFFFFFF
    assert (len(data) - 44) % 2 == 0 and len(data) > 44


def test_tts_binary_stream_audio_inline_codes(server):
    srv, *_ = server
    with _post_json(srv, "/mio/tts/stream", {"codes": list(range(40)),
                                             "reference_key": "preset",
                                             "stream_audio": True}) as r:
        assert r.headers["X-Audio-Streaming"] == "1"
        assert r.read()[:4] == b"RIFF"


@pytest.mark.parametrize("path", ["/mio/tts", "/mio/tts/stream"])
def test_tts_overlap_synthesis(server, path):
    srv, *_ = server
    with _post_json(srv, path, {"text": "overlap me", "reference_key": "preset",
                                "n_predict": 24, "overlap_synthesis": True}) as r:
        data = r.read()
    if path == "/mio/tts":
        j = json.loads(data)
        assert j["ok"] is True and j["mode"] == "synthesis_overlap"
        assert j["codes"] > 0 and j["n_audio"] > 0 and j["output_file"].endswith(".wav")
    else:
        assert data[:4] == b"RIFF" and int(r.headers["X-Audio-Samples"]) * 2 + 44 == len(data)


def test_sse_concurrent_streams_share_batcher(server):
    srv, *_ = server

    def one(i):
        with _post_json(srv, "/mio/tts/stream", {"text": f"concurrent {i}",
                                                 "reference_key": "preset",
                                                 "stream_tokens": True, "n_predict": 16}) as r:
            return _parse_sse(r.read().decode())[0]

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        for events in ex.map(one, range(4)):
            assert "generation_complete" in events and "audio_data" in events


def test_lane_independence_through_server(server):
    """A sampled codes_only request served alone returns the codes it
    returns beside a concurrent neighbour of another seed."""
    srv, *_ = server
    body = {"text": "same seed", "reference_key": "preset", "codes_only": True,
            "n_predict": 24, "seed": 7, "temp": 0.8, "top_k": 50}

    def codes(b):
        with _post_json(srv, "/mio/tts", b) as r:
            return json.loads(r.read())["codes_values"]

    alone = codes(body)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        together = list(ex.map(codes, [body, {**body, "seed": 8, "text": "a neighbour"}]))
    assert together[0] == alone and len(alone) > 0


@pytest.fixture(scope="module")
def engine_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("eng")
    _assets(d)
    return d


def _engine(d, **kw):
    cfg = _config(ServerConfig, d, str(d / "llm.gguf"), **kw)
    return ServingEngine(cfg, CPU), cfg


def test_overlap_matches_serial_duration(engine_dir):
    eng, cfg = _engine(engine_dir, n_predict=64, n_ctx=256)
    try:
        body = {"text": "same codes please", "reference_key": "preset", "n_predict": 48,
                "temp": 0.0, "seed": 3}
        out_s, out_o = {}, {}
        audio_s, sr_s = eng.run_tts_request(parse_request_json(body, cfg), out_s)
        audio_o, sr_o = eng.run_tts_request(
            parse_request_json({**body, "overlap_synthesis": True}, cfg), out_o)
    finally:
        eng.shutdown()
    assert out_o["mode"] == "synthesis_overlap" and out_s["codes"] == out_o["codes"] > 0
    assert sr_s == sr_o and audio_s.size == audio_o.size
    assert np.isfinite(audio_o).all() and np.abs(audio_o).max() > 0


def test_oversized_prompt_falls_back_to_dedicated_generation(engine_dir):
    eng, cfg = _engine(engine_dir, n_predict=24, n_ctx=96)
    try:
        rp = parse_request_json({"text": "oversized prompt " * 20, "reference_key": "preset",
                                 "n_predict": 16}, cfg)
        seen: list[int] = []
        out: dict = {}
        codes = eng._generate_codes(rp, out, on_token=lambda t, i, e: seen.append(t) or True)
    finally:
        eng.shutdown()
    assert codes and out["n_tokens"] == len(seen) > 0 and out["llm_ms"] > 0


def test_streaming_request_audio_before_generation_done(engine_dir):
    eng, cfg = _engine(engine_dir, n_predict=96, n_ctx=256)
    try:
        rp = parse_request_json({"text": "interleave please", "reference_key": "preset",
                                 "n_predict": 96}, cfg)
        seq = []
        audio, sr = eng.run_streaming_request(rp, {}, on_audio=lambda pcm: seq.append("audio"),
                                              on_codes=lambda codes: seq.append("codes_done"))
    finally:
        eng.shutdown()
    assert seq.index("audio") < seq.index("codes_done"), seq
    assert audio.size > 0 and sr == 24000


def test_server_pipeline_skips_the_process_wide_sync_check(engine_dir):
    """The server's codec pipeline runs without the sync-debug check, which
    is global to the process (the CLI's keeps it)."""
    eng, _ = _engine(engine_dir)
    try:
        assert eng.pipeline.check_syncs is False
    finally:
        eng.shutdown()


def test_warmup_runs_before_listening(engine_dir):
    """--warmup on on the CPU: nothing to capture, one warm request through
    the batcher before the server is constructed; the rest of the warm-up
    runs on a background thread, which ends with warmup_bg_done set and the
    batcher's cold-group split off."""
    eng, _ = _engine(engine_dir, warmup=True)
    try:
        assert eng.warmup_s > 0 and eng.warmup_fg_calls > 0 and eng.warmup_bg_calls > 0
        eng._warmup_bg_thread.join(timeout=120)
        assert eng.warmup_bg_done and eng.warmup_bg_s > 0
        assert not eng.batcher.split_cold_until_warm and eng.batcher._warm_state is None
        assert all(lane is None for lane in eng.batcher.lanes)
    finally:
        eng.shutdown()


def test_warmup_foreground_split(engine_dir, monkeypatch):
    """The warm calls split as JAX splits them: width 1 and the full width,
    the small prompt buckets' single prefills and the codec keys up to
    MIOTTS_WARMUP_FG_BUCKET (but the f32 streaming fallback's) before
    listening; MIOTTS_WARMUP_BG=0 warms everything in the foreground."""
    eng, _ = _engine(engine_dir)
    try:
        calls = eng._codec_warm_calls() + eng._llm_warm_calls()
        fg = {bk[0] if bk[1] is None else (bk[0], tuple(sorted(bk[1].items())))
              for bk in calls if eng._warm_is_fg(bk)}
        b = eng.batcher
        for rung in b.ladder:
            for wd in b.widths():
                assert eng._warm_is_fg((rung, {"chunk_width": wd})) == (wd in (1, b.n_lanes))
        assert eng._warm_is_fg((32, None)) and not eng._warm_is_fg((256, None))
        assert not eng._warm_is_fg((32, {"prefill_lanes": 2}))
        assert not eng._warm_is_fg((32, {"interp_anchor": 1024, "peak_normalize": False}))
        monkeypatch.setenv("MIOTTS_WARMUP_FG_BUCKET", "16")
        assert not eng._warm_is_fg((32, {"pcm16": True}))
        assert fg
    finally:
        eng.shutdown()
    monkeypatch.setenv("MIOTTS_WARMUP_BG", "0")
    eng, _ = _engine(engine_dir, warmup=True)
    try:
        assert eng.warmup_bg_done and eng.warmup_bg_calls == 0
        assert eng._warmup_bg_thread is None
    finally:
        eng.shutdown()


# -- the error surface against the JAX server -------------------------------------

def _probe(srv, method, path, body=None, headers=None):
    req = urllib.request.Request(_url(srv, path), data=body, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, None


def _j(obj):
    return json.dumps(obj).encode()


_PROBES = {
    "unknown_key": ("POST", "/mio/tts", _j({"codes": [1, 2], "reference_key": "nope"}), None),
    "malformed_json": ("POST", "/mio/tts", b"{bad json", None),
    "missing_reference_key": ("POST", "/mio/tts", _j({"codes": [1, 2]}), None),
    "slash_in_key": ("POST", "/mio/tts", _j({"codes": [1], "reference_key": "a/b"}), None),
    "slash_in_added_key": ("POST", "/mio/add_reference", _j({"key": "a/b", "path": "x"}), None),
    "get_on_post_route": ("GET", "/mio/tts", None, None),
    "unknown_route": ("POST", "/mio/nothing", _j({}), None),
    "body_too_large": ("POST", "/mio/tts", b"{}", {"Content-Length": str(300 * 1024 * 1024)}),
    "code_out_of_range": ("POST", "/mio/tts", _j({"codes": [99999], "reference_key": "preset"}),
                          None),
    "stream_tokens_without_text": ("POST", "/mio/tts/stream",
                                   _j({"codes": [1], "reference_key": "preset",
                                       "stream_tokens": True}), None),
    "n_ctx_too_large": ("POST", "/mio/tts", _j({"codes": [1], "reference_key": "preset",
                                                "n_ctx": 100000}), None),
    "generate_reference_without_wavlm": ("POST", "/mio/generate_reference",
                                         _j({"reference_key": "c1",
                                             "reference_audio": "/no/such.wav"}), None),
    "delete_unknown_key": ("DELETE", "/mio/references/never", None, None),
    "add_reference_missing_file": ("POST", "/mio/add_reference",
                                   _j({"key": "k1", "path": "/no/such.gguf"}), None),
    "codes_only": ("POST", "/mio/tts", _j({"codes": [5, 6], "codes_only": True,
                                           "reference_key": "preset"}), None),
}


@pytest.mark.parametrize("name", sorted(_PROBES))
def test_probe_matches_jax_server(server, jax_server, name):
    srv, *_ = server
    method, path, body, headers = _PROBES[name]
    got = _probe(srv, method, path, body, headers)
    ref = _probe(jax_server, method, path, body, headers)
    assert got[0] == ref[0], (got, ref)
    if ref[1] is None:
        assert got[1] is None
        return
    assert sorted(got[1]) == sorted(ref[1])
    if "error" in ref[1]:
        assert got[1]["error"] == ref[1]["error"]
    else:
        assert got[1] == {**ref[1], "slot": got[1].get("slot")}


def test_probe_503_slot_timeout_matches_jax_server(server, jax_server):
    """Every slot held and a slot timeout set: both servers shed the
    request with the same 503."""
    results = []
    for srv in (server[0], jax_server):
        held = [srv.engine.slots.acquire() for _ in range(srv.cfg.n_parallel)]
        srv.cfg.slot_timeout = 0.1
        try:
            results.append(_probe(srv, "POST", "/mio/tts",
                                  _j({"codes": [1, 2], "reference_key": "preset"})))
        finally:
            srv.cfg.slot_timeout = 0.0
            for s in held:
                srv.engine.slots.release(s)
    assert results[0] == results[1] and results[0][0] == 503


def test_health_keys_match_jax_server(server, jax_server):
    got = _probe(server[0], "GET", "/mio/health")[1]
    ref = _probe(jax_server, "GET", "/mio/health")[1]
    assert sorted(got) == sorted(ref)


def test_inline_codes_wav_matches_jax_server(server, jax_server):
    """/mio/tts/stream of the same inline codes: the port's WAV is the JAX
    server's within 4 PCM16 steps."""
    body = {"codes": np.random.RandomState(3).randint(0, 128, 37).tolist(),
            "reference_key": "preset"}
    wavs = []
    for srv in (server[0], jax_server):
        with _post_json(srv, "/mio/tts/stream", body) as r:
            wavs.append(r.read())
    assert wavs[0][:44] == wavs[1][:44]
    a, b = (np.frombuffer(w[44:], "<i2").astype(np.int32) for w in wavs)
    assert a.size == b.size > 0 and np.abs(a - b).max() <= 4


# -- flags and the entry point ----------------------------------------------------------

def test_reference_file_alias():
    """--reference-file is accepted as an alias of --reference-file-json."""
    p = build_arg_parser()
    spec = '{"key": "k", "path": "p"}'
    assert p.parse_args(["-mv", "c", "--reference-file", spec]).reference_file_json == spec
    assert p.parse_args(["-mv", "c", "--reference-file-json", spec]).reference_file_json == spec


@pytest.mark.parametrize("argv,flag", [
    (["--tts-wavlm-model", "w.gguf"], "--tts-wavlm-model"),
    (["--llm-api-url", "http://localhost:1"], "--llm-api-url"),
    (["--mio-backend-devices", "all"], "--mio-backend-devices"),
    (["--codec-devices", "all"], "--codec-devices"),
    (["-tp", "2"], "-tp/--tensor-parallel"),
])
def test_unported_flags_exit(capsys, monkeypatch, argv, flag):
    """Every server flag is ported: main goes past the flag checks to the
    device (an unknown platform here, so it stops there without loading a
    model), but for ``-tp 2`` without ``--mio-backend-devices``, which
    exits 1 with the JAX engine's error."""
    monkeypatch.setenv("MIOTTS_PLATFORM", "none")
    # main() defaults MIOTTS_PACKED_CACHE for the whole process; a value the
    # test owns keeps that from leaking into later tests of this worker
    # (their loads would replay deploy artifacts)
    monkeypatch.setenv("MIOTTS_PACKED_CACHE", "0")
    assert server_mod.main(["-mv", "c.gguf", *argv]) == 1
    err = capsys.readouterr().err
    assert "not yet" not in err
    if flag == "-tp/--tensor-parallel":
        assert err.startswith("error: --tensor-parallel requires --mio-backend-devices")
    else:
        assert err.startswith("error: MIOTTS_PLATFORM must be one of")


def test_module_entry_point_serves(engine_dir):
    """``python -m miotts_tpu_torch.serving.server`` under
    MIOTTS_PLATFORM=cpu listens and serves /mio/tts and /mio/tts/stream."""
    d = engine_dir
    env = dict(os.environ, MIOTTS_PLATFORM="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "miotts_tpu_torch.serving.server", "-mv", str(d / "codec.gguf"),
         "-m", str(d / "llm.gguf"), "--port", "0", "-np", "2", "-n", "16", "--ctx-size", "64",
         "--output-dir", str(d / "out"),
         "--reference-file", json.dumps({"key": "p", "path": str(d / "voice.emb.gguf")})],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(l) for l in proc.stderr], daemon=True).start()
    try:
        port = None
        while port is None:
            line = lines.get(timeout=120)  # queue.Empty fails the test
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])

        class _S:
            pass
        srv = _S()
        srv.port = port
        with _post_json(srv, "/mio/tts", {"text": "hi", "reference_key": "p"}) as r:
            assert json.loads(r.read())["ok"] is True
        with _post_json(srv, "/mio/tts/stream", {"codes": [1, 2, 3], "reference_key": "p"}) as r:
            assert r.read()[:4] == b"RIFF"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
