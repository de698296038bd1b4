"""The port's CLI (python -m miotts_tpu_torch.cli) on tiny GGUFs, on the CPU.

Codes -> WAV matches the JAX CLI's WAV within 2 LSB of int16. Text -> WAV
at --temp 0 writes a valid WAV whose --tts-mio-codes-out equals the port's
own LLMEngine output, on the dense path and with --llm-quant (or
MIOTTS_LLM_QUANT). --tts-stream-output writes a patched WAV within 2 LSB
of JAX's StreamingSynthesizer on the same codes, with the JAX CLI's errors
and precedence; --tts-remove-reference-key deletes as the JAX CLI does.
Flags whose path is not ported exit 1, and so does asking for CUDA where
there is none (the voice-cloning flags, ported since, are covered by
tests/test_torch_clone.py)."""

import struct

import numpy as np
import pytest
import torch

from miotts_tpu import cli as jax_cli
from miotts_tpu.gguf.writer import save_embedding_gguf
from miotts_tpu.pipeline import MioTTSPipeline as JaxPipeline
from miotts_tpu.runtime.audio_io import encode_pcm16 as jax_encode_pcm16
from miotts_tpu.runtime.codes_io import load_codes
from miotts_tpu.streaming import StreamingSynthesizer as JaxStreamingSynthesizer
from miotts_tpu_torch import cli
from miotts_tpu_torch.models.llm import LLMEngine
from miotts_tpu_torch.models.sampling import SamplerParams
from miotts_tpu_torch.testing import (
    tiny_codec_config, write_synthetic_llm_gguf, write_synthetic_miocodec_gguf)

torch.set_num_threads(1)
# a tiny wave codec with the 44.1 kHz codec's upsampler (one 2x stage, k=4)
UPS_CODEC = tiny_codec_config(sample_rate=44100, samples_per_token=64,
                              wave_upsampler_factors=(2,), wave_upsampler_kernel_sizes=(4,))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    cfg = tiny_codec_config()
    write_synthetic_miocodec_gguf(str(d / "codec.gguf"), cfg, seed=0)
    write_synthetic_miocodec_gguf(str(d / "codec441.gguf"), UPS_CODEC, seed=0)
    write_synthetic_llm_gguf(str(d / "llm.gguf"), n_audio=cfg.vocab_size, seed=1,
                             audio_logit_scale=3.0)
    write_synthetic_llm_gguf(str(d / "llm_q8_0.gguf"), n_audio=cfg.vocab_size, seed=1,
                             audio_logit_scale=3.0, quant="q8_0")
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


def test_codes_to_wav_upsampler_matches_jax_cli(assets, tmp_path, capsys):
    """Codes -> WAV on a codec with the wave upsampler: a 44 100 Hz WAV
    within 2 LSB of the JAX CLI's; on the CPU no decode is a graph's."""
    base = ["-mv", str(assets / "codec441.gguf"), "--tts-mio-codes-in",
            str(assets / "codes.txt"), "-emb", str(assets / "voice.emb.gguf")]
    assert jax_cli.main(base + ["-o", str(tmp_path / "jax.wav")]) == 0
    assert cli.main(base + ["-o", str(tmp_path / "port.wav")]) == 0
    assert ("codec_graph eager=0 captures=0 capture=0.0ms replays=0"
            in capsys.readouterr().err)
    sr_j, ref = _wav(tmp_path / "jax.wav")
    sr_p, got = _wav(tmp_path / "port.wav")
    assert sr_p == sr_j == 44100 and got.shape == ref.shape == (40 * 64,)
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


@pytest.mark.parametrize("quant,env", [("q8_0", ""), ("int8", ""), ("", "q8_0")])
def test_text_to_wav_quantized(assets, tmp_path, monkeypatch, capsys, quant, env):
    """--llm-quant q8_0 / int8 on the Q8_0-stored GGUF, and MIOTTS_LLM_QUANT
    with no flag: the codes written are the quantized engine's own
    (--cpu-native off: on a CPU device ``auto`` would pick the native engine
    for this GGUF, as the JAX CLI does)."""
    monkeypatch.setenv("MIOTTS_LLM_QUANT", env)
    out, codes_out = tmp_path / "q.wav", tmp_path / "codes.txt"
    rc = cli.main(["-mv", str(assets / "codec.gguf"), "-m", str(assets / "llm_q8_0.gguf"),
                   "-p", "Hello from the port", "-emb", str(assets / "voice.emb.gguf"),
                   "-n", "24", "--temp", "0", "--tts-mio-codes-out", str(codes_out),
                   "--cpu-native", "off", "-o", str(out)]
                  + (["--llm-quant", quant] if quant else []))
    assert rc == 0
    assert f"wrote {out}" in capsys.readouterr().err
    eng = LLMEngine(str(assets / "llm_q8_0.gguf"), torch.device("cpu"), quantize=quant or None)
    assert eng.quantize == (quant or env)
    assert isinstance(eng.weights["wqkv"], dict) and isinstance(eng.weights["output"], dict)
    expect = eng.tokens_to_codes(eng.generate_audio_tokens(
        "Hello from the port", n_predict=24, n_ctx=700, sampler=SamplerParams(temp=0.0)))
    assert expect and load_codes(codes_out) == expect
    _, pcm = _wav(out)
    assert pcm.size > 0 and np.abs(pcm).max() > 0


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
    ["--llm-api-url", "http://localhost:1"],
    ["--sequence-parallel", "2"],
    ["--cpu-native", "on"],
])
def test_unported_flags_exit_1(assets, extra, capsys, monkeypatch):
    """Each flag, ported, exits 1 on this codes request with the JAX CLI's
    error: the voice-cloning flags as they stand alone, --llm-api-url,
    --cpu-native on and --sequence-parallel 2 (codes win over the first
    two; this request has no embedding). --sequence-parallel runs under
    MIOTTS_PLATFORM=cpu and MIOTTS_LOGICAL_DEVICES=8, so the port has the 8
    ranks that JAX has forced CPU devices (tests/conftest.py)."""
    if extra[0] in ("--llm-api-url", "--sequence-parallel"):  # as far as the codec, on the CPU
        monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")
        monkeypatch.setenv("MIOTTS_LOGICAL_DEVICES", "8")
    argv = ["-mv", str(assets / "codec.gguf"), "--tts-mio-codes", "1 2 3"] + extra
    rc = cli.main(argv)
    err = capsys.readouterr().err
    assert rc == 1
    monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")
    assert jax_cli.main(argv) == 1
    assert err == capsys.readouterr().err and "not yet ported" not in err


def test_sequence_parallel_beyond_the_devices(assets, capsys, monkeypatch):
    """--sequence-parallel 2 on one CPU device exits 1 with the JAX CLI's
    error (miotts_tpu/cli.py:180-182)."""
    monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")
    monkeypatch.delenv("MIOTTS_LOGICAL_DEVICES", raising=False)
    rc = cli.main(["-mv", str(assets / "codec.gguf"), "--tts-mio-codes", "1 2 3",
                   "-emb", str(assets / "voice.emb.gguf"), "--sequence-parallel", "2"])
    assert rc == 1
    assert capsys.readouterr().err == "error: --sequence-parallel 2 > 1 visible devices\n"


def test_llm_quant_flag_is_ported(assets, tmp_path, capsys):
    """The command that exited 1 while --llm-quant was unported now runs."""
    rc = cli.main(["-mv", str(assets / "codec.gguf"), "--tts-mio-codes", "1 2 3",
                   "--llm-quant", "q8_0", "-emb", str(assets / "voice.emb.gguf"),
                   "-o", str(tmp_path / "o.wav")])
    assert rc == 0
    assert "not yet ported" not in capsys.readouterr().err


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


@pytest.mark.parametrize("quant,mode,native", [
    ("q8_0", "auto", True), ("q4_0", "auto", True), ("f32", "auto", False),
    ("f16", "auto", False), ("q8_0", "off", False), ("f32", "on", True),
])
def test_cpu_native_auto_notice(assets, tmp_path, capsys, quant, mode, native):
    """Under MIOTTS_PLATFORM=cpu the CLI picks its LLM engine by the JAX
    CLI's rule (miotts_tpu/cli.py _make_llm_engine): --cpu-native auto runs
    the native int8/int4 engine on a GGUF whose matmul weights are Q8_0 or
    Q4_0, ``on`` runs it on any GGUF (requantized), and a dense GGUF under
    auto, or ``off``, runs the torch engine. Sampled codes (seed 3) tell
    the engines apart: the native engine's equal the JAX CLI's, the torch
    engine's its own ``LLMEngine``'s."""
    from miotts_tpu.models.llm_cpu import gguf_llm_cpu_native_ok as jax_native_ok
    from miotts_tpu_torch.models.llm_cpu import gguf_llm_cpu_native_ok, gguf_llm_is_q8

    model = tmp_path / f"llm_{quant}.gguf"
    write_synthetic_llm_gguf(str(model), n_audio=128, seed=1, audio_logit_scale=3.0, quant=quant)
    assert gguf_llm_cpu_native_ok(str(model)) == jax_native_ok(str(model)) == (quant != "f32"
                                                                                and quant != "f16")
    assert gguf_llm_is_q8 is gguf_llm_cpu_native_ok
    argv = ["-mv", str(assets / "codec.gguf"), "-m", str(model), "-p", "Hello", "-n", "16",
            "--seed", "3", "--cpu-native", mode, "--tts-mio-codes-only"]
    assert cli.main(argv + ["--tts-mio-codes-out", str(tmp_path / "c.txt")]) == 0
    capsys.readouterr()
    got = load_codes(tmp_path / "c.txt")
    if native:
        assert jax_cli.main(argv + ["--tts-mio-codes-out", str(tmp_path / "jax.txt")]) == 0
        want = load_codes(tmp_path / "jax.txt")
    else:
        eng = LLMEngine(str(model), torch.device("cpu"))
        want = eng.tokens_to_codes(eng.generate_audio_tokens(
            "Hello", n_predict=16, n_ctx=700, sampler=SamplerParams(seed=3)))
    assert got and got == want


def _jax_stream_wav(codec, codes, emb):
    """JAX's StreamingSynthesizer fed ``codes`` as the CLI's stream feeds
    them (16 codes a feed, lookahead 8, then the rest and a flush), with the
    CLI's final peak rule, as int16 samples."""
    ss = JaxStreamingSynthesizer(JaxPipeline(codec), emb, lookahead_tokens=8)
    pieces = [ss.feed(codes[i:i + 16]) for i in range(0, len(codes), 16)] + [ss.finalize()]
    audio = np.concatenate(pieces)
    peak = float(np.abs(audio).max())
    if peak > 0.98:
        audio = audio * np.float32(0.95 / peak)
    return np.frombuffer(jax_encode_pcm16(audio), "<i2").astype(np.int32)


@pytest.mark.parametrize("codec", ["codec441.gguf"])
def test_stream_output_upsampler(assets, tmp_path, capsys, codec):
    """--tts-stream-output on the upsampler codec: a 44 100 Hz WAV within
    2/32768 of JAX's StreamingSynthesizer on the same codes."""
    out, codes_out = tmp_path / "stream.wav", tmp_path / "stream.codes"
    rc = cli.main(["-mv", str(assets / codec), "-m", str(assets / "llm.gguf"),
                   "-p", "stream this text", "-n", "48", "--temp", "0",
                   "-emb", str(assets / "voice.emb.gguf"), "--tts-stream-output",
                   "--tts-mio-codes-out", str(codes_out), "-o", str(out)])
    assert rc == 0
    assert "replays=0" in capsys.readouterr().err
    sr, pcm = _wav(out)
    codes = load_codes(codes_out)
    ref = _jax_stream_wav(str(assets / codec), codes,
                          np.random.RandomState(0).randn(16).astype(np.float32))
    assert sr == 44100 and pcm.shape == ref.shape == (len(codes) * 64,)
    assert np.abs(pcm - ref).max() <= 2 and np.abs(pcm).max() > 0


@pytest.mark.parametrize("n_predict", [24, 48])
def test_stream_output_greedy(assets, tmp_path, capsys, n_predict):
    """--tts-stream-output at --temp 0: the finished file is a WAV with
    patched sizes; its codes are the port's own greedy generate_audio_tokens;
    its samples are within 2/32768 of JAX's StreamingSynthesizer on those
    codes, fed the same way."""
    out, codes_out = tmp_path / "stream.wav", tmp_path / "stream.codes"
    rc = cli.main(["-mv", str(assets / "codec.gguf"), "-m", str(assets / "llm.gguf"),
                   "-p", "stream this text", "-n", str(n_predict), "--temp", "0",
                   "-emb", str(assets / "voice.emb.gguf"), "--tts-stream-output",
                   "--tts-mio-codes-out", str(codes_out), "-o", str(out)])
    assert rc == 0
    err = capsys.readouterr().err
    assert "synth breakdown: streaming ttfa=" in err and "redecodes=" in err
    data = out.read_bytes()
    assert struct.unpack_from("<I", data, 4)[0] == len(data) - 8
    assert struct.unpack_from("<I", data, 40)[0] == len(data) - 44
    sr, pcm = _wav(out)
    eng = LLMEngine(str(assets / "llm.gguf"), torch.device("cpu"))
    expect = eng.tokens_to_codes(eng.generate_audio_tokens(
        "stream this text", n_predict=n_predict, n_ctx=700, sampler=SamplerParams(temp=0.0)))
    codes = load_codes(codes_out)
    assert expect and codes == expect
    emb = np.random.RandomState(0).randn(16).astype(np.float32)
    ref = _jax_stream_wav(str(assets / "codec.gguf"), codes, emb)
    assert sr == 24000 and pcm.shape == ref.shape == (len(codes) * 32,)
    assert np.abs(pcm - ref).max() <= 2 and np.abs(pcm).max() > 0


def test_stream_output_needs_a_local_llm(assets, tmp_path, capsys):
    """Without -m (or with codes instead of a prompt) streaming is the JAX
    CLI's error."""
    argv = ["-mv", str(assets / "codec.gguf"), "--tts-stream-output",
            "-emb", str(assets / "voice.emb.gguf"), "-o", str(tmp_path / "x.wav")]
    for extra in (["--tts-mio-codes", "1,2,3"], ["-p", "hi"]):
        assert cli.main(argv + extra) == 1
        ours = capsys.readouterr().err
        assert jax_cli.main(argv + extra) == 1
        ref = capsys.readouterr().err
        assert "error: --tts-stream-output requires -p/--prompt with a local LLM (-m)" in ours
        assert ours.strip().splitlines()[-1] == ref.strip().splitlines()[-1]
    assert not (tmp_path / "x.wav").exists()


def test_stream_output_codes_only_takes_precedence(assets, tmp_path):
    co, no_wav = tmp_path / "only.codes", tmp_path / "should-not-exist.wav"
    rc = cli.main(["-mv", str(assets / "codec.gguf"), "-m", str(assets / "llm.gguf"),
                   "-p", "dump only", "-n", "16", "--temp", "0",
                   "-emb", str(assets / "voice.emb.gguf"), "-o", str(no_wav),
                   "--tts-stream-output", "--tts-mio-codes-only", "--tts-mio-codes-out", str(co)])
    assert rc == 0 and load_codes(co) and not no_wav.exists()


@pytest.mark.parametrize("case", ["removed", "missing_key", "no_dir"])
def test_remove_reference_key(assets, tmp_path, capsys, case):
    """--tts-remove-reference-key deletes <dir>/<key>.emb.gguf and says so;
    a missing key or a missing --tts-reference-dir is the JAX CLI's error."""
    outs = []
    for main in (cli.main, jax_cli.main):
        d = tmp_path / main.__module__
        d.mkdir()
        (d / "voice.emb.gguf").write_bytes(b"x")
        key = "nobody" if case == "missing_key" else "voice"
        argv = ["-mv", str(assets / "codec.gguf"), "--tts-remove-reference-key", key]
        rc = main(argv + ([] if case == "no_dir" else ["--tts-reference-dir", str(d)]))
        err = capsys.readouterr().err.strip().splitlines()[-1]
        outs.append((rc, err.replace(str(d), "<dir>"), (d / "voice.emb.gguf").exists()))
    assert outs[0] == outs[1]
    assert outs[0] == {"removed": (0, "removed reference: <dir>/voice.emb.gguf", False),
                       "missing_key": (1, "error: reference key not found: nobody", True),
                       "no_dir": (1, "error: --tts-reference-dir is required with "
                                  "--tts-remove-reference-key", True)}[case]
