"""The port's own copies of the JAX package's jax-free host modules behave
as the originals: the CLI parser has the same flags and defaults, each GGUF
reader reads the other package's writer to the same KVs and tensors, and
the tokenizer, code parser, WAV encoder and mel-L1 give the same results."""

import argparse

import numpy as np
import pytest

from miotts_tpu import MIO_CODE_MAX, MIO_CODE_MIN
from miotts_tpu import cli as jax_cli
from miotts_tpu import gguf as jax_gguf
from miotts_tpu import testing as jax_testing
from miotts_tpu.gguf.writer import load_embedding_gguf as jax_load_embedding
from miotts_tpu.gguf.writer import save_embedding_gguf as jax_save_embedding
from miotts_tpu.runtime import audio_io as jax_audio
from miotts_tpu.runtime import codes_io as jax_codes
from miotts_tpu.runtime import metrics as jax_metrics
from miotts_tpu.runtime.tokenizer import BPETokenizer as JaxBPETokenizer

import miotts_tpu_torch
from miotts_tpu_torch import cli, gguf, testing
from miotts_tpu_torch.gguf.writer import load_embedding_gguf, save_embedding_gguf
from miotts_tpu_torch.runtime import audio_io, codes_io, metrics
from miotts_tpu_torch.runtime.tokenizer import BPETokenizer


def _options(parser: argparse.ArgumentParser) -> dict:
    return {tuple(a.option_strings): (a.dest, a.default, a.choices, a.type, a.nargs, a.help,
                                      type(a).__name__)
            for a in parser._actions}


@pytest.mark.parametrize("cpu_native", ["", "1"])
def test_build_parser_matches(monkeypatch, cpu_native):
    monkeypatch.setenv("MIOTTS_CPU_NATIVE", cpu_native)
    assert _options(cli.build_parser()) == _options(jax_cli.build_parser())
    argv = ["-mv", "c.gguf", "-p", "hi", "-n", "7", "--llm-quant", "q8_0", "--top-p", "0.9"]
    ours, ref = (p.parse_args(argv) for p in (cli.build_parser(), jax_cli.build_parser()))
    assert vars(ours) == vars(ref)


def test_code_constants_match():
    assert (miotts_tpu_torch.MIO_CODE_MIN, miotts_tpu_torch.MIO_CODE_MAX) == (MIO_CODE_MIN,
                                                                              MIO_CODE_MAX)


def _same_file(path, reader_a, reader_b):
    with reader_a(path) as ra, reader_b(path) as rb:
        assert ra.kv == rb.kv and list(ra.tensors) == list(rb.tensors)
        for name, info in ra.tensors.items():
            other = rb.tensors[name]
            assert (info.shape, int(info.ggml_type), info.offset) == (
                other.shape, int(other.ggml_type), other.offset), name
            a, b = ra.tensor(name), rb.tensor(name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("quant", ["f32", "q8_0", "q4_0", "f16"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gguf_readers_read_each_others_files(tmp_path, writer, quant):
    path = str(tmp_path / "llm.gguf")
    write = (jax_testing if writer == "jax" else testing).write_synthetic_llm_gguf
    write(path, n_audio=16, dim=64, n_layers=1, ffn=64, seed=4, quant=quant)
    _same_file(path, gguf.GGUFReader, jax_gguf.GGUFReader)


def test_gguf_writers_write_the_same_bytes(tmp_path):
    rng = np.random.RandomState(0)
    arrays = {"f32": rng.randn(3, 64).astype(np.float32), "i32": np.arange(5, dtype=np.int32),
              "f16": rng.randn(8).astype(np.float16)}
    for mod, name in ((gguf, "port"), (jax_gguf, "jax")):
        w = mod.GGUFWriter(tmp_path / f"{name}.gguf", arch="test")
        w.add_uint32("a.u32", 7)
        w.add_float32("a.f32", 0.5)
        w.add_bool("a.bool", True)
        w.add_array_str("a.strs", ["x", "yz"])
        w.add_array_i32("a.i32s", [1, -2])
        w.add_array_f32("a.f32s", [1.5])
        for k, a in arrays.items():
            w.add_tensor(k, a)
        w.add_tensor_q8_0("q8", arrays["f32"])
        w.add_tensor_q4_0("q4", arrays["f32"])
        w.write()
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()
    emb = rng.randn(16).astype(np.float32)
    save_embedding_gguf(tmp_path / "p.emb.gguf", emb)
    jax_save_embedding(tmp_path / "j.emb.gguf", emb)
    assert (tmp_path / "p.emb.gguf").read_bytes() == (tmp_path / "j.emb.gguf").read_bytes()
    assert np.array_equal(load_embedding_gguf(tmp_path / "j.emb.gguf"),
                          jax_load_embedding(tmp_path / "p.emb.gguf"))


def test_tokenizer_matches(tmp_path):
    tokens, types = testing.synthetic_vocab(32, 4)
    kv = {"tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types,
          "tokenizer.ggml.merges": ["h e", "l l", "he ll"], "tokenizer.ggml.eos_token_id": 258}
    ours, ref = BPETokenizer.from_gguf_kv(kv), JaxBPETokenizer.from_gguf_kv(kv)
    text = "hello <|im_start|>日本語 text, 12345<|s_7|>\n"
    ids = ours.encode(text)
    assert ids == ref.encode(text)
    assert ours.decode(ids, special=True) == ref.decode(ids, special=True)
    assert all(ours.is_eog(i) == ref.is_eog(i) for i in range(len(tokens)))


def test_codes_wav_and_metrics_match(tmp_path):
    text = "<|s_5|>, 7,9.\n 12799"
    assert codes_io.parse_codes_text(text) == jax_codes.parse_codes_text(text)
    for bad in ("12800", "x1", ""):
        with pytest.raises(ValueError):
            codes_io.parse_codes_text(bad)
    codes_io.save_codes(tmp_path / "c.txt", [1, 2, 3])
    assert jax_codes.load_codes(tmp_path / "c.txt") == [1, 2, 3]
    audio = (np.random.RandomState(1).randn(4000) * 0.5).astype(np.float32)
    assert audio_io.wav16_header(10, 24000) == jax_audio.wav16_header(10, 24000)
    assert audio_io.encode_pcm16(audio) == jax_audio.encode_pcm16(audio)
    audio_io.save_wav16(tmp_path / "p.wav", audio, 24000)
    jax_audio.save_wav16(tmp_path / "j.wav", audio, 24000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    other = audio + 0.01 * np.sin(np.arange(4000, dtype=np.float32))
    assert metrics.mel_l1(audio, other, 24000) == jax_metrics.mel_l1(audio, other, 24000)


@pytest.mark.parametrize("sample_rate,channels", [(24000, 1), (44100, 1), (16000, 2)])
def test_wav16_streaming_header_matches(sample_rate, channels):
    """The streaming WAV header (0xFFFFFFFF sizes, patched when the stream
    ends) is byte-equal to the JAX package's."""
    got = audio_io.wav16_streaming_header(sample_rate, channels)
    assert got == jax_audio.wav16_streaming_header(sample_rate, channels)
    assert len(got) == 44 and got[4:8] == got[40:44] == b"\xff\xff\xff\xff"


def test_encode_wav16_matches():
    audio = (np.random.RandomState(2).randn(3000) * 0.6).astype(np.float32)
    assert audio_io.encode_wav16(audio, 24000) == jax_audio.encode_wav16(audio, 24000)
    pcm = np.rint(np.clip(audio, -1, 1) * 32767).astype(np.int16)
    assert audio_io.encode_wav16(pcm, 44100) == jax_audio.encode_wav16(pcm, 44100)


def test_webui_copy_matches():
    from miotts_tpu.serving import webui as jax_webui
    from miotts_tpu_torch.serving import webui

    for name in ("INDEX_HTML", "UI_CSS", "UI_JS"):
        assert getattr(webui, name) == getattr(jax_webui, name), name


_BODIES = [
    {"text": "hi", "reference_key": "voice", "n_predict": 12, "temp": 0.3, "top_k": 7,
     "stream_tokens": True, "seed": 4},
    {"prompt": "p", "tts_reference_key": "k.1", "codes_only": True, "n_ctx": 50},
    {"codes": [1, "<|s_5|>", 7.0], "key": "a-b", "stream_audio": True, "overlap_synthesis": 1},
    {"input": "x", "embedding_only": True, "embedding_in": "e.gguf", "top_p": 0.5},
    {"codes": [1, 2]},
    {"codes": "1 2", "reference_key": "k"},
    {"codes": [99999], "reference_key": "k"},
    {"codes": ["<|bad|>"], "reference_key": "k"},
    {"codes": [{}], "reference_key": "k"},
    {"text": "hi", "reference_key": "a/b"},
    {"text": "hi", "reference_key": "k", "n_ctx": 0},
    {"text": "hi", "reference_key": "k", "n_ctx": 100000},
    {"text": "hi", "reference_key": "k", "n_predict": 0},
    {"embedding_only": True},
]


@pytest.mark.parametrize("i", range(len(_BODIES)))
def test_server_state_copy_matches(i):
    """The port's serving/state.py copy parses every request as the JAX
    package's: the same fields, or the same error text and code."""
    import dataclasses

    from miotts_tpu.serving import state as jax_state
    from miotts_tpu_torch.serving import state

    def run(mod):
        try:
            return dataclasses.asdict(mod.parse_request_json(_BODIES[i], mod.ServerConfig()))
        except mod.RequestError as e:
            return (str(e), e.code)

    assert run(state) == run(jax_state)
    assert ([(f.name, f.default) for f in dataclasses.fields(state.ServerConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jax_state.ServerConfig)])
    for key in ("ok_key-1.2", "a/b", "", "x" * 129):
        assert state.is_valid_reference_key(key) == jax_state.is_valid_reference_key(key)


def test_reference_cache_copy_matches():
    from miotts_tpu.serving import state as jax_state
    from miotts_tpu_torch.serving import state

    caches = [state.ReferenceCache(), jax_state.ReferenceCache()]
    for c in caches:
        c.put("b", np.ones((2, 3)))
        c.put("a", np.zeros(4))
        assert c.remove("b") and not c.remove("missing")
    assert caches[0].items() == caches[1].items() and len(caches[0]) == len(caches[1]) == 1
    assert np.array_equal(caches[0].get("a"), caches[1].get("a"))


def test_server_parser_matches():
    """The port's server flags are the JAX server's, plus the
    --reference-file alias of --reference-file-json."""
    from miotts_tpu.serving.server import build_arg_parser as jax_parser
    from miotts_tpu_torch.serving.server import build_arg_parser

    ours, ref = _options(build_arg_parser()), _options(jax_parser())
    alias = ("--reference-file-json", "--reference-file")
    assert ours.pop(alias) == ref.pop(("--reference-file-json",))
    assert ours == ref
    argv = ["-mv", "c.gguf", "-m", "l.gguf", "-np", "8", "--warmup", "on", "--llm-quant", "q8_0"]
    assert vars(build_arg_parser().parse_args(argv)) == vars(jax_parser().parse_args(argv))


_API_RESPONSES = [
    {"codes": [1, 2, 3]},
    {"codes_values": [4]},
    {"audio_codes": [5, "6"]},
    {"codes": []},
    {"codes": "1 2"},
    {"choices": [{"message": {"content": "<|s_7|><|s_8|>"}}]},
    {"choices": [{"text": "<|s_9|> <|s_-3|>"}]},
    {"output_text": "<|s_10|>"},
    {"text": ["<|s_11|>", {"text": "<|s_12|>"}, {"type": "x"}]},
    {"choices": [{"message": {"content": [{"type": "text", "text": "<|s_1|>"}, "<|s_2|>"]}}]},
    {"choices": [{"message": {"content": "nope"}}]},
    {"choices": []},
    {},
]


@pytest.mark.parametrize("i", range(len(_API_RESPONSES)))
def test_llm_api_copy_matches(i):
    """The port's runtime/llm_api.py copy parses every response shape as
    the JAX package's: the same codes and text, or the same error."""
    from miotts_tpu.runtime import llm_api as jax_api
    from miotts_tpu_torch.runtime import llm_api

    def run(mod):
        rsp = _API_RESPONSES[i]
        try:
            codes = mod.parse_codes_from_response(rsp)
        except ValueError as e:
            codes = ("error", str(e))
        return codes, mod.extract_text_from_response(rsp)

    assert run(llm_api) == run(jax_api)
    text = "a <|s_1|><|s_22|> and <|s_333|> <|s_x|>"
    assert llm_api.extract_codes_from_text(text) == jax_api.extract_codes_from_text(text)


@pytest.mark.parametrize("helper", ["decode_fsq_indices", "weight_norm_fuse_dim0",
                                    "weight_norm_fuse_dim2", "fuse_pos_conv_weight", "silu",
                                    "is_matmul_weight", "conv_geometry"])
def test_converter_copies_match(helper):
    """The port's converters/ copies of miotts_tpu/convert/'s helpers give
    the same values (bit for bit) and the same decisions."""
    from miotts_tpu.convert import miocodec as jax_mc
    from miotts_tpu.convert import quantize as jax_q
    from miotts_tpu.convert import wavlm as jax_wl
    from miotts_tpu_torch.converters import miocodec as mc
    from miotts_tpu_torch.converters import quantize as q
    from miotts_tpu_torch.converters import wavlm as wl

    rng = np.random.RandomState(1)
    v, g = rng.randn(6, 4, 5).astype(np.float32), rng.rand(6).astype(np.float32) + 0.5
    pos_v, pos_g = rng.randn(8, 3, 16).astype(np.float32), rng.rand(1, 1, 16).astype(np.float32)
    idx = np.arange(12800, dtype=np.int64)
    cases = {
        "decode_fsq_indices": lambda m: m.decode_fsq_indices(idx, [8, 5, 5, 8, 8]),
        "weight_norm_fuse_dim0": lambda m: m.weight_norm_fuse(g, v, dim=0),
        "weight_norm_fuse_dim2": lambda m: m.weight_norm_fuse(pos_g, pos_v, dim=2),
        "silu": lambda m: m._silu(rng.randn(64).astype(np.float32)),
    }
    if helper in cases:
        st = rng.get_state()
        got = cases[helper](mc)
        rng.set_state(st)
        assert got.tobytes() == cases[helper](jax_mc).tobytes()
    elif helper == "fuse_pos_conv_weight":
        assert (wl.fuse_pos_conv_weight(pos_v, pos_g).tobytes()
                == jax_wl.fuse_pos_conv_weight(pos_v, pos_g).tobytes())
    elif helper == "conv_geometry":
        assert (wl.CONV_KERNELS, wl.CONV_STRIDES) == (jax_wl.CONV_KERNELS, jax_wl.CONV_STRIDES)
        assert q._TARGETS == jax_q._TARGETS
    else:
        class Info:
            def __init__(self, name, shape):
                self.name, self.shape = name, shape

        for name, shape in (("blk.0.attn_q.weight", (64, 64)), ("blk.0.attn_norm.weight", (64,)),
                            ("output_norm.weight", (8, 64)), ("token_embd.weight", (96, 64)),
                            ("blk.0.ffn_up.weight", (64, 48)), ("blk.0.bias", (64, 64))):
            assert q._is_matmul_weight(Info(name, shape)) == jax_q._is_matmul_weight(
                Info(name, shape)), name
