"""The port's external LLM API client (miotts_tpu_torch/runtime/llm_api.py)
against the JAX package's (tests/test_llm_api.py): the response-parsing
ladder, both request modes against a local stub endpoint, and the port's
CLI and server taking a text request's codes from it on the CPU, each WAV
equal to ``pipeline.synthesize`` of the stub's codes."""

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from miotts_tpu.runtime import llm_api as jax_api
from miotts_tpu_torch import cli
from miotts_tpu_torch.gguf.writer import save_embedding_gguf
from miotts_tpu_torch.pipeline import MioTTSPipeline
from miotts_tpu_torch.runtime import llm_api
from miotts_tpu_torch.serving.server import MioTTSServer
from miotts_tpu_torch.serving.state import ServerConfig
from miotts_tpu_torch.testing import tiny_codec_config, write_synthetic_miocodec_gguf

torch.set_num_threads(1)
CPU = torch.device("cpu")
CODES = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4]


def test_extract_codes_from_text():
    for text in ("<|s_1|><|s_22|> and <|s_333|>", "no codes here", "<|s_-4|>"):
        assert llm_api.extract_codes_from_text(text) == jax_api.extract_codes_from_text(text)
    assert llm_api.extract_codes_from_text("<|s_1|><|s_22|>") == [1, 22]


def test_parse_codes_ladder():
    for rsp in ({"codes": [1, 2, 3]}, {"codes_values": [4]}, {"audio_codes": [5]},
                {"choices": [{"message": {"content": "<|s_7|><|s_8|>"}}]},
                {"choices": [{"text": "<|s_9|>"}]}, {"output_text": "<|s_10|>"}):
        assert llm_api.parse_codes_from_response(rsp) == jax_api.parse_codes_from_response(rsp)
    for bad in ({"choices": [{"message": {"content": "nope"}}]}, {"codes": []}):
        with pytest.raises(ValueError) as ours:
            llm_api.parse_codes_from_response(bad)
        with pytest.raises(ValueError) as ref:
            jax_api.parse_codes_from_response(bad)
        assert str(ours.value) == str(ref.value)


def test_extract_text_content_array():
    rsp = {"choices": [{"message": {"content": [{"type": "text", "text": "<|s_1|>"},
                                                "<|s_2|>"]}}]}
    assert llm_api.extract_text_from_response(rsp) == jax_api.extract_text_from_response(rsp)
    assert llm_api.extract_codes_from_text(llm_api.extract_text_from_response(rsp)) == [1, 2]


@pytest.fixture()
def fake_api():
    """A stub endpoint: openai-chat requests get the codes as message
    text, generic ones as a ``text`` field; both as ``<|s_N|>``."""
    received = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            received.append({"body": body, "auth": self.headers.get("Authorization"),
                             "x": self.headers.get("X-Extra")})
            text = "".join(f"<|s_{c}|>" for c in CODES)
            rsp = ({"choices": [{"message": {"content": text}}]} if "messages" in body
                   else {"text": text})
            data = json.dumps(rsp).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/v1/chat/completions", received
    srv.shutdown()


@pytest.mark.parametrize("mode", ["openai-chat", "generic"])
def test_request_modes_match_jax(fake_api, mode):
    """Each mode sends the JAX client's payload and headers and returns the
    same codes."""
    url, received = fake_api
    args = (url, "secret", "some-model", '{"X-Extra": "1"}', 30, mode, "say hi", 50, 0.7, 0.9,
            40, 1.1, 7)
    assert llm_api._build(*args) == jax_api._build(*args) == CODES
    ours, ref = received
    assert ours == ref
    assert ours["auth"] == "Bearer secret" and ours["x"] == "1"
    if mode == "openai-chat":
        assert ours["body"]["messages"] == [{"role": "user", "content": "say hi"}]
    else:
        assert ours["body"]["prompt"] == "say hi" and ours["body"]["n_predict"] == 50


def test_http_error_matches_jax():
    """An unreachable endpoint fails both clients alike."""
    args = ("http://127.0.0.1:9/x", "", "", "", 5, "generic", "t", 1, 0.8, 1.0, 50, 1.0, 0)
    with pytest.raises(ValueError, match="LLM API request failed") as ours:
        llm_api._build(*args)
    with pytest.raises(ValueError) as ref:
        jax_api._build(*args)
    assert str(ours.value) == str(ref.value)


@pytest.fixture(scope="module")
def codec(tmp_path_factory):
    d = tmp_path_factory.mktemp("api")
    cfg = tiny_codec_config()
    write_synthetic_miocodec_gguf(str(d / "codec.gguf"), cfg, seed=0)
    emb = np.random.RandomState(0).randn(cfg.decoder_adanorm_dim).astype(np.float32)
    save_embedding_gguf(d / "voice.emb.gguf", emb)
    pipe = MioTTSPipeline(str(d / "codec.gguf"), CPU)
    ref = pipe.synthesize(CODES, emb).audio
    return d, np.rint(np.clip(ref, -1, 1) * 32767).astype(np.int32)


def _pcm(data: bytes) -> np.ndarray:
    """The int16 samples of a mono 16-bit WAV with the 44-byte header."""
    assert data[:4] == b"RIFF" and data[36:40] == b"data"
    return np.frombuffer(data[44:], "<i2").astype(np.int32)


def test_cli_external_api_end_to_end(fake_api, codec, tmp_path, monkeypatch):
    """cli -p with --llm-api-url (no -m) writes the WAV of the stub's codes,
    within one PCM16 step of pipeline.synthesize; MIO_TTS_LLM_API_URL is
    its fallback."""
    url, received = fake_api
    d, ref16 = codec
    monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")
    out = tmp_path / "api.wav"
    rc = cli.main(["-mv", str(d / "codec.gguf"), "--llm-api-url", url, "-p", "hello",
                   "-emb", str(d / "voice.emb.gguf"), "-o", str(out)])
    assert rc == 0 and received[-1]["body"]["messages"][0]["content"] == "hello"
    pcm = _pcm(out.read_bytes())
    assert pcm.size == ref16.size and np.abs(pcm - ref16).max() <= 1
    monkeypatch.setenv("MIO_TTS_LLM_API_URL", url)
    rc = cli.main(["-mv", str(d / "codec.gguf"), "-p", "again", "--llm-api-mode", "generic",
                   "-emb", str(d / "voice.emb.gguf"), "-o", str(tmp_path / "env.wav")])
    assert rc == 0 and received[-1]["body"]["prompt"] == "again"
    assert (tmp_path / "env.wav").read_bytes() == out.read_bytes()


@pytest.mark.parametrize("mode", ["openai-chat", "generic"])
def test_server_external_api_end_to_end(fake_api, codec, mode):
    """A server with --llm-api-url and no LLM serves /mio/tts text requests
    from the stub (health says so); the WAV equals pipeline.synthesize of
    the stub's codes within one PCM16 step."""
    url, received = fake_api
    d, ref16 = codec
    cfg = ServerConfig(model_vocoder=str(d / "codec.gguf"), host="127.0.0.1", port=0,
                       output_dir=str(d / "out"), n_parallel=2, llm_api_url=url,
                       llm_api_mode=mode, reference_file_json=json.dumps(
                           {"key": "voice", "path": str(d / "voice.emb.gguf")}))
    srv = MioTTSServer(cfg, CPU)
    srv.start_background()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/mio/health", timeout=60) as r:
            health = json.loads(r.read())
        assert health["external_llm_enabled"] is True and health["external_llm_mode"] == mode
        req = urllib.request.Request(base + "/mio/tts/stream", data=json.dumps(
            {"text": "hi there", "reference_key": "voice"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            pcm = _pcm(r.read())
        assert pcm.size == ref16.size and np.abs(pcm - ref16).max() <= 1
        req = urllib.request.Request(base + "/mio/tts", data=json.dumps(
            {"text": "codes please", "reference_key": "voice", "codes_only": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert body["ok"] and body["codes_values"] == CODES
        assert srv.engine.llm is None and srv.engine.batcher is None
        last = received[-1]["body"]
        assert (last["messages"][0]["content"] if mode == "openai-chat"
                else last["prompt"]) == "codes please"
    finally:
        srv.shutdown()
