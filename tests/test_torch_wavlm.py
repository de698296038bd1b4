"""The port's WavLM extractor (miotts_tpu_torch/models/wavlm.py) and its two
convolutions (ops/convs.py) against the JAX package on the CPU: the same
seeded numpy inputs and the same weights through both.

The relative-position bucket table equals JAX's exactly; the convolutions
agree within 1e-5, the forward (ssl, ssl_pre, frame lengths) within 1e-4,
at the tiny config of tests/test_wavlm.py with a ragged batch of two and
at WavLM Base+'s full widths on a 1 s reference."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.models import wavlm as jax_wavlm
from miotts_tpu.ops import convs as jax_convs
from miotts_tpu.testing import write_synthetic_wavlm_gguf as jax_write_wavlm
from miotts_tpu_torch.convert import wavlm_params_from_jax
from miotts_tpu_torch.models import wavlm
from miotts_tpu_torch.ops import convs
from miotts_tpu_torch.runtime.audio_io import save_wav16
from miotts_tpu_torch.testing import full_wavlm_kwargs, write_synthetic_wavlm_gguf

torch.set_num_threads(1)
CPU = torch.device("cpu")
CONV_TOL = 1e-5
FWD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("num_buckets,max_distance", [(320, 800), (32, 50)])
def test_bucket_table_equals_jax(num_buckets, max_distance):
    """Every relative position |k - q| <= 2048 lands in JAX's bucket, and the
    [T, T] table is JAX's bucket of (k - q)."""
    rel = np.arange(-2048, 2049, dtype=np.int32)
    ref = np.asarray(jax_wavlm.relative_position_bucket(jnp.asarray(rel), num_buckets,
                                                        max_distance))
    got = wavlm.relative_position_bucket(rel, num_buckets, max_distance)
    np.testing.assert_array_equal(got, ref)
    cfg = wavlm.WavLMConfig(num_buckets=num_buckets, max_distance=max_distance)
    q = np.arange(999, dtype=np.int32)
    ref_table = np.asarray(jax_wavlm.relative_position_bucket(
        jnp.asarray(q[None, :] - q[:, None]), num_buckets, max_distance))
    np.testing.assert_array_equal(wavlm.bucket_table(cfg, 999), ref_table)


@pytest.mark.parametrize("cin,cout,k,stride,pad,dilation,T", [
    (1, 16, 10, 5, 0, 1, 403),   # the first conv of the feature stack
    (16, 16, 3, 2, 0, 1, 80),
    (16, 16, 2, 2, 0, 1, 41),
    (8, 12, 5, 3, 2, 1, 57),
    (8, 8, 3, 1, 2, 2, 33),
])
def test_conv1d_strided_matches_jax(cin, cout, k, stride, pad, dilation, T):
    rng = np.random.RandomState(k * 31 + stride)
    x = rng.randn(2, T, cin).astype(np.float32)
    w = (rng.randn(cout, cin, k) / np.sqrt(cin * k)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    ref = np.asarray(jax_convs.conv1d_strided(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                              stride=stride, pad=pad, dilation=dilation))
    got = convs.conv1d_strided(_t(x), _t(w), _t(b), stride=stride, pad=pad,
                               dilation=dilation).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= CONV_TOL


@pytest.mark.parametrize("C,k,T", [(20, 7, 50), (384, 7, 50), (6, 3, 9), (5, 4, 17)])
def test_conv1d_depthwise_same_matches_jax(C, k, T):
    rng = np.random.RandomState(C + k)
    x = rng.randn(2, T, C).astype(np.float32)
    w = (rng.randn(C, 1, k) / np.sqrt(k)).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    ref = np.asarray(jax_convs.conv1d_depthwise_same(jnp.asarray(x), jnp.asarray(w),
                                                     jnp.asarray(b)))
    got = convs.conv1d_depthwise_same(_t(x), _t(w), _t(b)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= CONV_TOL


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("wavlm") / "tiny_wavlm.gguf"
    write_synthetic_wavlm_gguf(str(path), seed=0)
    cfg, w = jax_wavlm.load_wavlm(str(path))
    return str(path), cfg, w


def _forwards(cfg, w, wav, lengths):
    """(JAX outputs, port outputs) of wavlm_forward on the same weights."""
    ref = jax.jit(jax_wavlm.wavlm_forward, static_argnums=0)(
        cfg, jax.tree.map(jnp.asarray, w), jnp.asarray(wav), jnp.asarray(lengths))
    pcfg, pw = wavlm_params_from_jax(cfg, w, CPU)
    got = wavlm.wavlm_forward(pcfg, pw, _t(wav), _t(lengths))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def test_loader_matches_jax(tiny):
    path, cfg, w = tiny
    pcfg, pw = wavlm.load_wavlm(path, CPU)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    ref = jax.tree_util.tree_leaves_with_path(w)
    got = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), pw))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (p, a), (_, b) in zip(got, ref):
        assert a.dtype == np.float32 and np.array_equal(a, b), p


def test_forward_tiny_ragged_matches_jax(tiny):
    """B = 2, one lane padded: ssl, ssl_pre and the frame lengths."""
    _, cfg, w = tiny
    rng = np.random.RandomState(0)
    wav = np.zeros((2, 512), np.float32)
    lengths = np.array([512, 300], np.int32)
    wav[0] = rng.randn(512) * 0.3
    wav[1, :300] = rng.randn(300) * 0.3
    ref, got = _forwards(cfg, w, wav, lengths)
    np.testing.assert_array_equal(got[2], ref[2])
    for name, g, r in zip(("ssl", "ssl_pre"), got, ref):
        assert g.shape == r.shape, name
        assert np.abs(g - r).max() <= FWD_TOL, name
        assert not g[1, ref[2][1]:].any(), name  # exactly 0 past the frames


def test_forward_padding_invariance(tiny):
    """A reference padded to a longer bucket gives the unpadded features."""
    _, cfg, w = tiny
    pcfg, pw = wavlm_params_from_jax(cfg, w, CPU)
    rng = np.random.RandomState(1)
    n = 300
    x = (rng.randn(n) * 0.3).astype(np.float32)
    padded = np.zeros((1, 512), np.float32)
    padded[0, :n] = x
    a, _, fa = wavlm.wavlm_forward(pcfg, pw, _t(x[None]), torch.tensor([n], dtype=torch.int32))
    b, _, fb = wavlm.wavlm_forward(pcfg, pw, _t(padded), torch.tensor([n], dtype=torch.int32))
    T = int(fa[0])
    assert int(fb[0]) == T
    np.testing.assert_allclose(a[0, :T].numpy(), b[0, :T].numpy(), rtol=1e-4, atol=1e-5)


def test_forward_full_width_one_second_matches_jax(tmp_path):
    """WavLM Base+'s widths on a 1 s reference (bucket 16 000, 49 frames)."""
    path = tmp_path / "wavlm_full.gguf"
    write_synthetic_wavlm_gguf(str(path), seed=2, **full_wavlm_kwargs())
    cfg, w = jax_wavlm.load_wavlm(str(path))
    assert (cfg.n_heads, cfg.head_dim, cfg.embed_dim, cfg.num_buckets, cfg.max_distance) == (
        12, 64, 768, 320, 800)
    rng = np.random.RandomState(3)
    wav = np.zeros((1, 16000), np.float32)
    wav[0, :15000] = rng.randn(15000) * 0.3
    ref, got = _forwards(cfg, w, wav, np.array([15000], np.int32))
    assert got[0].shape == (1, 49, 768)
    np.testing.assert_array_equal(got[2], ref[2])
    for g, r in zip(got[:2], ref[:2]):
        assert np.abs(g - r).max() <= FWD_TOL


@pytest.mark.parametrize("kwargs", [{}, {"n_layers": 1, "n_heads": 2, "head_dim": 16,
                                         "conv_kernel": (4, 2), "conv_stride": (2, 2),
                                         "seed": 5}])
def test_writer_writes_jax_bytes(tmp_path, kwargs):
    jax_write_wavlm(str(tmp_path / "jax.gguf"), **kwargs)
    write_synthetic_wavlm_gguf(str(tmp_path / "port.gguf"), **kwargs)
    assert (tmp_path / "jax.gguf").read_bytes() == (tmp_path / "port.gguf").read_bytes()


@pytest.mark.parametrize("n", [1, 7999, 8000, 8001, 200000, 320000, 480001, 1000000])
def test_wav_buckets_match_jax(tiny, n):
    path, _, _ = tiny
    assert wavlm.WavLMExtractor.pick_wav_bucket(n) == jax_wavlm.WavLMExtractor.pick_wav_bucket(
        None, n)
    cfg = wavlm.WavLMConfig()
    assert cfg.conv_out_len(n) == jax_wavlm.WavLMConfig().conv_out_len(n)


def test_full_reference_frames():
    """A 20 s reference: 320 000 samples, 999 frames through the stack."""
    cfg = wavlm.WavLMConfig()
    assert wavlm.WavLMExtractor.pick_wav_bucket(20 * 16000) == 320000
    assert cfg.conv_out_len(320000) == 999


def test_audio_stat_fallback_matches_jax():
    wav = np.random.RandomState(3).randn(1000).astype(np.float32)
    np.testing.assert_array_equal(wavlm._audio_stat_fallback(wav, 24),
                                  jax_wavlm._audio_stat_fallback(wav, 24))


def test_extractor_end_to_end_matches_jax(tiny, tmp_path):
    """Decode, normalize, resample, pad and forward: the same features."""
    path, cfg, _ = tiny
    rng = np.random.RandomState(2)
    sr = 24000
    audio = (0.5 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)
             + 0.1 * rng.randn(sr)).astype(np.float32)
    save_wav16(tmp_path / "ref.wav", audio, sr)
    ext = wavlm.WavLMExtractor(path, CPU)
    ssl, n_frames = ext.extract_ssl_features(str(tmp_path / "ref.wav"), source_rate=sr)
    ref, ref_frames = jax_wavlm.WavLMExtractor(path).extract_ssl_features(
        str(tmp_path / "ref.wav"), source_rate=sr)
    assert n_frames == ref_frames == cfg.conv_out_len(16000)
    assert ssl.shape == ref.shape and np.abs(ssl - ref).max() <= FWD_TOL
    np.testing.assert_array_equal(
        ext.preprocess_reference(str(tmp_path / "ref.wav"), sr),
        jax_wavlm.WavLMExtractor.preprocess_reference(
            type("E", (), {"config": cfg})(), str(tmp_path / "ref.wav"), sr))
