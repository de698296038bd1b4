"""The codec's precision knob in the port, on the CPU.

``MIOTTS_CODEC_MATMUL`` (ops/precision.py): read once when a pipeline is
built; ``float32`` and ``tensorfloat32`` (the port's f32 path) decode
bit-equal to the knob unset, within the fidelity bar, mel-L1 < 1e-2, of
the JAX package's f32 decode of the same GGUF; ``bfloat16`` changes the
decode (the knob is live) and stays within the bar on the wave codec, and
on the mel codec in its trunk (its vocoder's conv_post at bf16 misses the
bar); the reference chain (WavLM, the global encoder) gives the same
embedding bit for bit whatever the knob; the operand rounding is bf16's
(round to nearest even), and the mode is per thread.

``MIOTTS_VOCODER_FUSE`` is not read: the port's vocoder always runs its
resblocks branch by branch (the K6 path), which on ragged resblock
kernels 3/5/7 matches the numpy oracle (rtol 2e-3 / atol 2e-4, as
tests/test_vocoder.py:84-125 holds the JAX package's) and the JAX
package's default path.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_vocoder as oracle
from miotts_tpu.gguf import GGUFReader
from miotts_tpu.models import vocoder as JV
from miotts_tpu.models.miocodec import codec_synthesize as jax_synthesize
from miotts_tpu.models.miocodec import load_miocodec as jax_load
from miotts_tpu_torch.models import vocoder as V
from miotts_tpu_torch.models.miocodec import codec_decode_spec, load_miocodec
from miotts_tpu_torch.ops import precision
from miotts_tpu_torch.ops.cuda import activation1d as k5
from miotts_tpu_torch.ops.cuda import resblock as k6
from miotts_tpu_torch.pipeline import MioTTSPipeline
from miotts_tpu_torch.runtime.audio_io import save_wav16
from miotts_tpu_torch.testing import (
    mel_l1, tiny_codec_config, write_synthetic_mel_vocoder_gguf, write_synthetic_miocodec_gguf,
    write_synthetic_wavlm_gguf)

torch.set_num_threads(1)
CPU = torch.device("cpu")
MEL_L1_MAX = 1e-2
MEL_CFG = dict(model_type=1, n_mels=12, n_fft=64, hop_length=16, samples_per_token=32,
               resnet_blocks=0, vocoder_upsample_rates=(4, 2, 2))
N_CODES = 48


@pytest.fixture(scope="module")
def codecs(tmp_path_factory):
    """The tiny wave codec (with a global encoder of 32 inputs, the tiny
    WavLM's width) and a tiny mel codec, a WavLM and a 1 s reference."""
    d = tmp_path_factory.mktemp("knobs")
    write_synthetic_miocodec_gguf(str(d / "wave.gguf"),
                                  tiny_codec_config(global_encoder_input_channels=32), seed=0)
    write_synthetic_mel_vocoder_gguf(str(d / "mel.gguf"),
                                     tiny_codec_config(vocoder_num_kernels=2, **MEL_CFG), seed=0)
    write_synthetic_wavlm_gguf(str(d / "wavlm.gguf"), seed=2)
    t = np.arange(24000) / 24000
    save_wav16(d / "ref.wav", (0.4 * np.sin(2 * np.pi * 220 * t)
                               + 0.05 * np.random.RandomState(0).randn(t.size)).astype(np.float32),
               24000)
    return d


def _request(seed: int = 3):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 128, N_CODES), rng.randn(16).astype(np.float32)


def _decode(path, monkeypatch, mode: str | None) -> np.ndarray:
    """A fresh pipeline built with the knob set to ``mode`` (None: unset),
    then the knob set to something else before the decode: the build's
    value holds."""
    if mode is None:
        monkeypatch.delenv("MIOTTS_CODEC_MATMUL", raising=False)
    else:
        monkeypatch.setenv("MIOTTS_CODEC_MATMUL", mode)
    pipe = MioTTSPipeline(path, CPU)
    assert pipe.codec_matmul == (mode or "float32")
    monkeypatch.setenv("MIOTTS_CODEC_MATMUL", "bfloat16" if mode != "bfloat16" else "float32")
    codes, emb = _request()
    return pipe.synthesize(codes, emb).audio


@functools.lru_cache(maxsize=None)
def _jax_f32(path: str) -> np.ndarray:
    codes, emb = _request()
    jcfg, jw = jax_load(path)
    bucket = 64
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :N_CODES] = codes
    audio, n = jax.jit(functools.partial(jax_synthesize, jcfg))(
        jax.tree.map(jnp.asarray, jw), jnp.asarray(tokens), jnp.asarray([N_CODES], jnp.int32),
        jnp.asarray(emb)[None])
    return np.asarray(audio)[0, :int(n[0])]


@pytest.mark.parametrize("mode", ["float32", "tensorfloat32"])
@pytest.mark.parametrize("codec", ["wave", "mel"])
def test_f32_modes_bit_equal_to_unset(codecs, monkeypatch, codec, mode):
    """The knob at ``float32`` or ``tensorfloat32`` decodes bit-equal to
    the knob unset, within the bar of the JAX package's f32 decode."""
    path = codecs / f"{codec}.gguf"
    a = _decode(path, monkeypatch, None)
    b = _decode(path, monkeypatch, mode)
    assert a.size > 0 and a.tobytes() == b.tobytes()
    assert mel_l1(a, _jax_f32(str(path)), 24000) < MEL_L1_MAX


def test_bfloat16_wave_meets_fidelity_bar(codecs, monkeypatch):
    """Against the JAX package's f32 decode (the CPU's, whatever its
    precision knob): mel-L1 < 1e-2, while the decode differs from the
    port's f32 one (the knob reached the codec)."""
    path = codecs / "wave.gguf"
    ref = _jax_f32(str(path))
    got = _decode(path, monkeypatch, "bfloat16")
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert mel_l1(got, ref, 24000) < MEL_L1_MAX
    assert got.tobytes() != _decode(path, monkeypatch, "float32").tobytes()


def test_bfloat16_mel_trunk_meets_fidelity_bar(codecs, monkeypatch):
    """A mel decode at bfloat16 does not meet the bar here (mel-L1 0.0236
    against the JAX f32 decode): the JAX package's scope takes the
    vocoder's conv_post to bf16 too, and rounding its waveform-rate input
    to 8 bits of mantissa raises the quiet mel bins' noise floor. The
    trunk at bf16 does meet it, its mel spectrogram through the f32
    vocoder; and the whole bf16 decode is finite, of the f32 decode's
    length and not equal to it."""
    path = codecs / "mel.gguf"
    ref = _jax_f32(str(path))
    got = _decode(path, monkeypatch, "bfloat16")
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert got.tobytes() != _decode(path, monkeypatch, "float32").tobytes()
    cfg, w = load_miocodec(str(path), CPU)
    codes, emb = _request()
    tokens = torch.zeros((1, 64), dtype=torch.int64)
    tokens[0, :N_CODES] = torch.from_numpy(codes)
    lengths = torch.tensor([N_CODES], dtype=torch.int32)
    spec, frames = codec_decode_spec(cfg, w, tokens, lengths, torch.from_numpy(emb)[None],
                                     matmul="bfloat16")
    audio, n = V.vocoder_decode(cfg, w, spec, frames)
    peak = np.abs(audio[0, :int(n[0])].numpy()).max()
    trunk_bf16 = audio[0, :int(n[0])].numpy() * (0.95 / peak if peak > 0.98 else 1.0)
    assert mel_l1(trunk_bf16, ref, 24000) < MEL_L1_MAX


@pytest.mark.parametrize("mode", ["bfloat16", "tensorfloat32"])
def test_knob_leaves_reference_embedding(codecs, monkeypatch, mode):
    """The knob is the codec's: WavLM and the global encoder run at f32, so
    a reference's embedding is bit-equal under each mode."""
    embs = []
    for m in ("float32", mode):
        monkeypatch.setenv("MIOTTS_CODEC_MATMUL", m)
        pipe = MioTTSPipeline(codecs / "wave.gguf", CPU, wavlm_path=codecs / "wavlm.gguf")
        embs.append(pipe.reference_to_embedding(codecs / "ref.wav"))
    assert embs[0].tobytes() == embs[1].tobytes()


def test_unknown_mode_refused(codecs, monkeypatch):
    monkeypatch.setenv("MIOTTS_CODEC_MATMUL", "highest")
    with pytest.raises(ValueError, match="MIOTTS_CODEC_MATMUL"):
        MioTTSPipeline(codecs / "wave.gguf", CPU)


def _round_mantissa(x: np.ndarray, keep: int) -> np.ndarray:
    """f32 values rounded to ``keep`` mantissa bits, to nearest, ties to
    even, in float64 arithmetic on the exponent's grid."""
    x64 = x.astype(np.float64)
    m, e = np.frexp(x64)  # x = m 2^e, 0.5 <= |m| < 1
    scale = np.ldexp(1.0, keep + 1)
    return np.ldexp(np.round(m * scale) / scale, e).astype(np.float32)


def test_operand_rounding():
    mode, keep = "bfloat16", 7
    rng = np.random.RandomState(0)
    ties = [0.0, -0.0, 1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11]
    x = np.concatenate([rng.randn(4000) * 10.0 ** rng.randint(-6, 6, 4000),
                        ties]).astype(np.float32)
    with precision.codec_matmul(mode):
        got = precision.operand(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _round_mantissa(x, keep))
    a, b = rng.randn(5, 7, 33).astype(np.float32), rng.randn(33, 9).astype(np.float32)
    with precision.codec_matmul(mode):
        out = precision.mm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = _round_mantissa(a, keep).astype(np.float64) @ _round_mantissa(b, keep)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_tensorfloat32_is_the_f32_path():
    """Under ``tensorfloat32`` an operand is left as it is and a matmul is
    the plain f32 one, bit for bit."""
    rng = np.random.RandomState(1)
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((5, 7, 33), (33, 9)))
    with precision.codec_matmul("tensorfloat32"):
        assert precision.operand(a) is a
        assert torch.equal(precision.mm(a, b), a @ b)


def test_mode_is_per_thread():
    """A context on one thread leaves another thread at float32, and
    nothing outside a context rounds."""
    x = torch.tensor([1.0 + 2.0 ** -12])
    seen, ready, done = {}, threading.Event(), threading.Event()

    def other():
        ready.wait(10)
        seen["mode"], seen["x"] = precision.current(), precision.operand(x)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with precision.codec_matmul("bfloat16"):
        ready.set()
        assert done.wait(10)
        assert precision.operand(x).item() == 1.0
    t.join(10)
    assert not t.is_alive() and seen["mode"] == "float32" and seen["x"] is x
    assert precision.current() == "float32" and precision.operand(x) is x


# -- MIOTTS_VOCODER_FUSE is not read ---------------------------------------------------

@pytest.fixture(scope="module")
def ragged(tmp_path_factory):
    """tests/test_vocoder.py's ragged-kernel mel vocoder (3 resblocks a stage
    of kernels 3/5/7) and a mel input of 8 frames."""
    cfg = tiny_codec_config(vocoder_num_kernels=3, **MEL_CFG)
    path = tmp_path_factory.mktemp("ragged") / "ragged.gguf"
    write_synthetic_mel_vocoder_gguf(str(path), cfg, seed=5, resblock_kernels=(3, 5, 7))
    with GGUFReader(path) as r:
        raw = {name: np.array(r.tensor(name)) for name in r.tensors}
    mel_ct = (np.random.RandomState(3).randn(cfg.n_mels, 8) * 0.5).astype(np.float32)
    return path, raw, mel_ct


def _port_vocoder(path, mel_ct) -> np.ndarray:
    cfg, w = load_miocodec(str(path), CPU)
    audio, n = V.vocoder_decode(cfg, w, torch.from_numpy(mel_ct.T.copy())[None],
                                torch.tensor([mel_ct.shape[1]], dtype=torch.int32))
    return audio[0, :int(n[0])].numpy()


def test_ragged_vocoder_matches_oracle_and_jax(ragged, monkeypatch):
    """Ragged resblock kernels 3/5/7 branch by branch: the numpy oracle's
    tolerance (rtol 2e-3 / atol 2e-4) and the JAX package's default path
    at tests/test_torch_vocoder.py's (rtol 1e-4 / atol 1e-5)."""
    path, raw, mel_ct = ragged
    monkeypatch.delenv("MIOTTS_VOCODER_FUSE", raising=False)
    cfg, _ = load_miocodec(str(path), CPU)
    ref = oracle.decode_mel_to_audio(raw, {
        "mel_postnet_layers": cfg.mel_postnet_layers, "norm_eps": cfg.norm_eps,
        "vocoder_upsample_rates": cfg.vocoder_upsample_rates,
        "vocoder_num_kernels": cfg.vocoder_num_kernels}, mel_ct)
    got = _port_vocoder(path, mel_ct)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
    jcfg, jw = jax_load(str(path))
    audio, n = jax.jit(lambda w, m, l: JV.vocoder_decode(jcfg, w, m, l))(
        jax.tree.map(jnp.asarray, jw), jnp.asarray(mel_ct.T)[None],
        jnp.asarray([mel_ct.shape[1]], jnp.int32))
    np.testing.assert_allclose(got, np.asarray(audio)[0, :int(n[0])], rtol=1e-4, atol=1e-5)


def test_vocoder_fuse_knob_is_unread(ragged, codecs, monkeypatch):
    """With ``MIOTTS_VOCODER_FUSE=1`` every resblock layer still goes
    through the K6 wrapper's route (here its plain version): below 1 024
    rows a layer is two K5 calls, as with the knob unset; and a mel
    pipeline's decode is bit-equal to one built without it."""
    path, _, mel_ct = ragged
    calls = {"k5": 0, "k6": 0}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(k5, "activation1d", counting("k5", k5.activation1d))
    monkeypatch.setattr(k6, "resblock_layer", counting("k6", k6.resblock_layer))
    monkeypatch.setenv("MIOTTS_VOCODER_FUSE", "1")
    fused_env = _port_vocoder(path, mel_ct)
    # 8 frames -> 32/64/128 rows: 3 stages x 3 branches x 3 layers, two
    # K5 calls each, and the activation after the last stage
    assert calls == {"k5": 3 * 3 * 3 * 2 + 1, "k6": 0}
    monkeypatch.delenv("MIOTTS_VOCODER_FUSE")
    assert fused_env.tobytes() == _port_vocoder(path, mel_ct).tobytes()
    codes, emb = _request()
    out = {}
    for value in ("0", "1"):
        monkeypatch.setenv("MIOTTS_VOCODER_FUSE", value)
        out[value] = MioTTSPipeline(codecs / "mel.gguf", CPU).synthesize(codes, emb).audio
    assert out["1"].size > 0 and out["1"].tobytes() == out["0"].tobytes()
