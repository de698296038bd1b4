"""The native C client bridges end to end against the port's server, the
flow of tests/test_client_bindings.py, each test once with the JAX
package's bridge (miotts_tpu/bindings) and once with the port's own copy
(miotts_tpu_torch/bindings): a server with ``--tts-wavlm-model`` turns an
uploaded recording into a reference that text requests then use; a server
without it answers the JAX server's own 400 ("server requires
--tts-wavlm-model ...") and takes a reference from a GGUF instead. The two
bridges then upload the committed mp3 fixture and synthesize the same
request with the same seed: the same embedding and WAV bytes.

JAX's bridge is built here into the test's temporary directory, not into
the JAX package's tree (its ``_OUT`` is pointed there before its first
load); the port's builds into build/miotts_tpu_torch/."""

import json
import math
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from miotts_tpu_torch.gguf.writer import save_embedding_gguf
from miotts_tpu_torch.serving.server import MioTTSServer
from miotts_tpu_torch.serving.state import ServerConfig
from miotts_tpu_torch.testing import (
    tiny_codec_config, write_synthetic_llm_gguf, write_synthetic_miocodec_gguf,
    write_synthetic_wavlm_gguf)

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("clang++") is None,
    reason="no C++ compiler")

torch.set_num_threads(1)

MP3_REF = Path(__file__).parent / "torch_assets" / "ref3.mp3"


@pytest.fixture(scope="module", params=["jax", "port"])
def client_cls(request, tmp_path_factory):
    """``MioTPUClient`` of the JAX package's bridge or of the port's."""
    if request.param == "port":
        from miotts_tpu_torch.bindings import MioTPUClient

        yield MioTPUClient
        return
    from miotts_tpu.bindings import client as jax_client

    with pytest.MonkeyPatch.context() as mp:
        if jax_client._lib is None:  # built outside the JAX package's tree
            mp.setattr(jax_client, "_OUT",
                       tmp_path_factory.mktemp("jax_bridge") / "libmio_tpu_client.so")
            jax_client._load()
        yield jax_client.MioTPUClient


def _server(d, wavlm: bool):
    # a global encoder of 32 input channels matches the tiny WavLM's width
    cfg_codec = tiny_codec_config(global_encoder_input_channels=32)
    write_synthetic_miocodec_gguf(str(d / "codec.gguf"), cfg_codec, seed=0)
    write_synthetic_llm_gguf(str(d / "llm.gguf"), n_audio=cfg_codec.vocab_size, seed=1,
                             audio_logit_scale=3.0)
    if wavlm:
        write_synthetic_wavlm_gguf(str(d / "wavlm.gguf"), seed=2)
    save_embedding_gguf(d / "voice.emb.gguf",
                        np.random.RandomState(0).randn(cfg_codec.decoder_adanorm_dim)
                        .astype(np.float32))
    cfg = ServerConfig(
        model_vocoder=str(d / "codec.gguf"), model=str(d / "llm.gguf"),
        wavlm_model=str(d / "wavlm.gguf") if wavlm else "", host="127.0.0.1",
        port=0, output_dir=str(d / "out"), n_parallel=2, n_predict=16, n_ctx=128,
        reference_file_json=json.dumps({"key": "preset", "path": str(d / "voice.emb.gguf")}))
    srv = MioTTSServer(cfg, torch.device("cpu"))
    srv.start_background()
    return srv


@pytest.fixture(scope="module")
def bridge_server(tmp_path_factory):
    d = tmp_path_factory.mktemp("bridge")
    srv = _server(d, wavlm=True)
    yield srv, d
    srv.shutdown()


@pytest.fixture(scope="module")
def bridge_server_no_wavlm(tmp_path_factory):
    d = tmp_path_factory.mktemp("bridge_nowavlm")
    srv = _server(d, wavlm=False)
    yield srv, d
    srv.shutdown()


def _make_wav(path, seconds=1.0, sr=16000):
    n = int(sr * seconds)
    pcm = b"".join(struct.pack("<h", int(8000 * math.sin(2 * math.pi * 180 * i / sr)))
                   for i in range(n))
    path.write_bytes(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
                     + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
                     + b"data" + struct.pack("<I", len(pcm)) + pcm)


def test_bridge_end_to_end(client_cls, bridge_server, tmp_path):
    MioTPUClient = client_cls
    srv, d = bridge_server
    with MioTPUClient(f"http://127.0.0.1:{srv.port}") as c:
        assert json.loads(c.health_json())["status"] == "ok"

        # voice clone through the bridge (multipart upload, GGUF download)
        _make_wav(tmp_path / "voice.wav")
        c.create_reference_from_audio("bridge_voice", str(tmp_path / "voice.wav"),
                                      max_reference_seconds=5.0,
                                      embedding_out_path=str(tmp_path / "bridge.emb.gguf"))
        assert (tmp_path / "bridge.emb.gguf").read_bytes()[:4] == b"GGUF"
        c.add_reference_from_gguf("bridge_copy", str(tmp_path / "bridge.emb.gguf"))
        keys = [r["key"] for r in json.loads(c.list_references_json())["references"]]
        assert {"preset", "bridge_voice", "bridge_copy"} <= set(keys)

        # text -> wav with the new key (UTF-8 + JSON escaping through the C layer)
        c.set_generation_params(n_predict=12, top_k=40, top_p=0.95, temp=0.7, seed=3)
        out = tmp_path / "tts.wav"
        c.synthesize_to_wav('こんにちは、"テスト"です。\n', "bridge_voice", str(out))
        assert out.read_bytes()[:4] == b"RIFF"

        # codes -> wav (chunked-WAV decode in the C client)
        out2 = tmp_path / "codes.wav"
        c.synthesize_codes_to_wav([1, 2, 3, 4, 5, 6, 7, 8], "preset", str(out2))
        data = out2.read_bytes()
        assert data[:4] == b"RIFF" and len(data) > 44

        c.remove_reference("bridge_voice")
        c.remove_reference("bridge_copy")
        keys = [r["key"] for r in json.loads(c.list_references_json())["references"]]
        assert "bridge_voice" not in keys and "bridge_copy" not in keys


def test_bridge_reference_needs_wavlm(client_cls, bridge_server_no_wavlm, tmp_path):
    """Without --tts-wavlm-model the clone call gets the server's 400; a
    reference added from a GGUF serves a text request."""
    MioTPUClient = client_cls
    srv, d = bridge_server_no_wavlm
    with MioTPUClient(f"http://127.0.0.1:{srv.port}") as c:
        _make_wav(tmp_path / "voice.wav")
        with pytest.raises(RuntimeError, match="tts-wavlm-model"):
            c.create_reference_from_audio("bridge_voice", str(tmp_path / "voice.wav"),
                                          max_reference_seconds=5.0,
                                          embedding_out_path=str(tmp_path / "bridge.emb.gguf"))
        c.add_reference_from_gguf("bridge_copy", str(d / "voice.emb.gguf"))
        c.set_generation_params(n_predict=12, top_k=40, top_p=0.95, temp=0.7, seed=3)
        out = tmp_path / "tts.wav"
        c.synthesize_to_wav("hello", "bridge_copy", str(out))
        assert out.read_bytes()[:4] == b"RIFF"


def test_bridge_error_paths(client_cls, bridge_server, tmp_path):
    MioTPUClient = client_cls
    srv, _ = bridge_server
    with pytest.raises(ConnectionError):
        MioTPUClient("http://127.0.0.1:9")  # nothing listens on port 9
    with pytest.raises(ConnectionError):
        MioTPUClient("ftp://bad.scheme")
    with MioTPUClient(f"http://127.0.0.1:{srv.port}") as c:
        with pytest.raises(RuntimeError, match="not found"):
            c.synthesize_to_wav("x", "no_such_ref", str(tmp_path / "x.wav"))
        with pytest.raises(RuntimeError, match="not found"):
            c.remove_reference("never_existed")
        with pytest.raises(RuntimeError, match="cannot open file"):
            c.add_reference_from_gguf("k", str(tmp_path / "missing.gguf"))


def test_bridges_same_bytes(bridge_server, tmp_path, monkeypatch):
    """The JAX package's bridge and the port's upload the committed mp3
    fixture (which the server decodes natively, its LAME Info frame
    skipped) and synthesize one text request with one seed: the same
    embedding GGUF and the same WAV bytes from both."""
    from miotts_tpu.bindings import client as jax_client
    from miotts_tpu_torch.bindings import MioTPUClient
    from miotts_tpu_torch.runtime import native

    srv, _ = bridge_server
    if jax_client._lib is None:  # built outside the JAX package's tree
        monkeypatch.setattr(jax_client, "_OUT", tmp_path / "libmio_tpu_client.so")
    out = {}
    for name, cls in (("jax", jax_client.MioTPUClient), ("port", MioTPUClient)):
        with cls(f"http://127.0.0.1:{srv.port}") as c:
            m0 = native.calls["mio_mp3_decode"]
            c.create_reference_from_audio(f"mp3_{name}", str(MP3_REF),
                                          embedding_out_path=str(tmp_path / f"{name}.emb.gguf"))
            assert native.calls["mio_mp3_decode"] == m0 + 1  # the server decoded it natively
            c.set_generation_params(n_predict=12, top_k=40, top_p=0.95, temp=0.7, seed=11)
            c.synthesize_to_wav("the same request", f"mp3_{name}", str(tmp_path / f"{name}.wav"))
        out[name] = ((tmp_path / f"{name}.emb.gguf").read_bytes(),
                     (tmp_path / f"{name}.wav").read_bytes())
    assert out["jax"][1][:4] == b"RIFF" and len(out["jax"][1]) > 44
    assert out["jax"] == out["port"]
