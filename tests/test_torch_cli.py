"""The port's CLI (python -m miotts_tpu_torch.cli) on tiny GGUFs, on the CPU.

Codes -> WAV matches the JAX CLI's WAV within 2 LSB of int16. Text -> WAV
at --temp 0 writes a valid WAV whose --tts-mio-codes-out equals the port's
own LLMEngine output. Flags whose path is not ported exit 1, and so does
asking for CUDA where there is none."""

import struct

import numpy as np
import pytest
import torch

from miotts_tpu import cli as jax_cli
from miotts_tpu.gguf.writer import save_embedding_gguf
from miotts_tpu.runtime.codes_io import load_codes
from miotts_tpu_torch import cli
from miotts_tpu_torch.models.llm import LLMEngine
from miotts_tpu_torch.models.sampling import SamplerParams
from miotts_tpu_torch.testing import (
    tiny_codec_config, write_synthetic_llm_gguf, write_synthetic_miocodec_gguf)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    cfg = tiny_codec_config()
    write_synthetic_miocodec_gguf(str(d / "codec.gguf"), cfg, seed=0)
    write_synthetic_llm_gguf(str(d / "llm.gguf"), n_audio=cfg.vocab_size, seed=1,
                             audio_logit_scale=3.0)
    save_embedding_gguf(d / "voice.emb.gguf",
                        np.random.RandomState(0).randn(16).astype(np.float32))
    (d / "codes.txt").write_text(
        "\n".join(str(c) for c in np.random.RandomState(1).randint(0, 128, 40)))
    return d


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")


def _wav(path):
    data = path.read_bytes()
    riff, size, wave, fmt, _, pcm, ch, sr, _, _, bits, tag, n = struct.unpack_from(
        "<4sI4s4sIHHIIHH4sI", data)
    assert (riff, wave, fmt, tag, pcm, ch, bits) == (b"RIFF", b"WAVE", b"fmt ", b"data", 1, 1, 16)
    assert size == 36 + n and len(data) == 44 + n
    return sr, np.frombuffer(data[44:], "<i2").astype(np.int32)


def test_codes_to_wav_matches_jax_cli(assets, tmp_path):
    base = ["-mv", str(assets / "codec.gguf"), "--tts-mio-codes-in", str(assets / "codes.txt"),
            "-emb", str(assets / "voice.emb.gguf")]
    assert jax_cli.main(base + ["-o", str(tmp_path / "jax.wav")]) == 0
    assert cli.main(base + ["-o", str(tmp_path / "port.wav")]) == 0
    sr_j, ref = _wav(tmp_path / "jax.wav")
    sr_p, got = _wav(tmp_path / "port.wav")
    assert sr_p == sr_j == 24000 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 2
    assert np.abs(got).max() > 0


def test_text_to_wav_greedy(assets, tmp_path, capsys):
    out, codes_out = tmp_path / "t1.wav", tmp_path / "codes.txt"
    prompt = tmp_path / "prompt.txt"
    prompt.write_text("Hello from the port\n")
    rc = cli.main(["-mv", str(assets / "codec.gguf"), "-m", str(assets / "llm.gguf"),
                   "--prompt-file", str(prompt), "--tts-mio-embedding-in",
                   str(assets / "voice.emb.gguf"), "-n", "24", "--temp", "0",
                   "--tts-mio-codes-out", str(codes_out), "-o", str(out)])
    assert rc == 0
    err = capsys.readouterr().err
    assert "synth breakdown: decode=" in err and f"wrote {out}" in err
    eng = LLMEngine(str(assets / "llm.gguf"), torch.device("cpu"))
    expect = eng.tokens_to_codes(eng.generate_audio_tokens(
        "Hello from the port", n_predict=24, n_ctx=700, sampler=SamplerParams(temp=0.0)))
    assert expect and load_codes(codes_out) == expect
    _, pcm = _wav(out)
    n_fft, hop = 64, 16
    frames = (len(expect) * 32) // hop
    assert pcm.size == (frames - 1) * hop + n_fft - 2 * ((n_fft - hop) // 2)


def test_codes_only(assets, tmp_path):
    codes_out = tmp_path / "c.txt"
    rc = cli.main(["-mv", str(assets / "codec.gguf"), "--tts-mio-codes", "<|s_5|> 7,9",
                   "--tts-mio-codes-out", str(codes_out), "--tts-mio-codes-only",
                   "-o", str(tmp_path / "none.wav")])
    assert rc == 0 and load_codes(codes_out) == [5, 7, 9]
    assert not (tmp_path / "none.wav").exists()


@pytest.mark.parametrize("extra", [
    ["--tts-reference-audio", "ref.wav"],
    ["--tts-wavlm-model", "w.gguf"],
    ["--tts-mio-embedding-only"],
    ["--tts-remove-reference-key", "k"],
    ["--tts-stream-output", "-p", "hi"],
    ["--llm-api-url", "http://localhost:1"],
    ["--sequence-parallel", "2"],
    ["--llm-quant", "q8_0"],
    ["--cpu-native", "on"],
])
def test_unported_flags_exit_1(assets, extra, capsys):
    rc = cli.main(["-mv", str(assets / "codec.gguf"), "--tts-mio-codes", "1 2 3"] + extra)
    assert rc == 1
    assert "not yet ported to miotts_tpu_torch" in capsys.readouterr().err


def test_cuda_without_a_card_is_an_error(assets, monkeypatch, capsys):
    monkeypatch.setenv("MIOTTS_PLATFORM", "cuda")
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    rc = cli.main(["-mv", str(assets / "codec.gguf"), "--tts-mio-codes", "1 2 3",
                   "-emb", str(assets / "voice.emb.gguf")])
    assert rc == 1 and "torch.cuda.is_available() is False" in capsys.readouterr().err


def test_input_errors(assets, capsys):
    assert cli.main(["--tts-mio-codes", "1"]) == 1
    assert cli.main(["-mv", str(assets / "codec.gguf")]) == 1
    assert cli.main(["-mv", str(assets / "codec.gguf"), "-p", "hi"]) == 1
    assert cli.main(["-mv", str(assets / "codec.gguf"), "--tts-mio-codes", "1 2"]) == 1
    err = capsys.readouterr().err
    assert "-mv/--model-vocoder is required" in err and "no input" in err
    assert "-m/--model is required" in err and "requires embedding" in err
