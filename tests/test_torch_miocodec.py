"""The port's MioCodec decoder against the JAX package on one tiny GGUF,
loaded by each package's own loader and again through
``miocodec_params_from_jax``. Audio atol 1e-4 (f32 end to end; the peak
normalization gain amplifies the ops' 1e-6-level differences)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.models.miocodec import codec_synthesize as jax_synthesize
from miotts_tpu.models.miocodec import load_miocodec as jax_load
from miotts_tpu_torch.convert import miocodec_params_from_jax
from miotts_tpu_torch.models.miocodec import codec_synthesize, load_miocodec
from miotts_tpu_torch.pipeline import MioTTSPipeline
from miotts_tpu_torch.testing import tiny_codec_config, write_synthetic_miocodec_gguf

torch.set_num_threads(1)
CPU = torch.device("cpu")
LENGTHS = np.array([50, 23], np.int32)


@pytest.fixture(scope="module")
def codec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("codec") / "tiny.gguf")
    write_synthetic_miocodec_gguf(path, tiny_codec_config(), seed=0)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 128, (2, 64)).astype(np.int32)
    cond = rng.randn(2, 16).astype(np.float32)
    jcfg, jw = jax_load(path)
    synth = jax.jit(functools.partial(jax_synthesize, jcfg))
    audio, n = synth(jax.tree.map(jnp.asarray, jw), jnp.asarray(tokens),
                     jnp.asarray(LENGTHS), jnp.asarray(cond))
    return path, jcfg, jw, tokens, cond, np.asarray(audio), np.asarray(n)


def test_config_matches_jax(codec):
    path, jcfg, *_ = codec
    pcfg, _ = load_miocodec(path, CPU)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("source", ["gguf", "jax_tree"])
def test_synthesize_matches_jax(codec, source):
    path, jcfg, jw, tokens, cond, ref_audio, ref_n = codec
    if source == "gguf":
        cfg, w = load_miocodec(path, CPU)
    else:
        cfg, w = miocodec_params_from_jax(jcfg, jw, CPU)
    audio, n = codec_synthesize(cfg, w, torch.from_numpy(tokens),
                                torch.from_numpy(LENGTHS), torch.from_numpy(cond),
                                matmul="float32")
    assert np.array_equal(n.numpy(), ref_n)
    np.testing.assert_allclose(audio.numpy(), ref_audio, atol=1e-4, rtol=0)
    for b, k in enumerate(ref_n):
        assert np.all(audio[b, k:].numpy() == 0)
        assert np.all(np.isfinite(audio[b, :k].numpy())) and np.any(audio[b, :k].numpy() != 0)


def test_anchored_unnormalized_matches_jax(codec):
    """The streaming options: a resize ratio pinned to an anchor token count
    and no peak normalization."""
    path, jcfg, jw, tokens, cond, _, _ = codec
    synth = jax.jit(functools.partial(jax_synthesize, jcfg, interp_anchor_tokens=40,
                                      peak_normalize=False))
    ref, ref_n = synth(jax.tree.map(jnp.asarray, jw), jnp.asarray(tokens),
                       jnp.asarray(LENGTHS), jnp.asarray(cond))
    cfg, w = load_miocodec(path, CPU)
    audio, n = codec_synthesize(cfg, w, torch.from_numpy(tokens), torch.from_numpy(LENGTHS),
                                torch.from_numpy(cond), interp_anchor_tokens=40,
                                peak_normalize=False, matmul="float32")
    assert np.array_equal(n.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_padded_bucket_matches_unpadded(codec):
    """torch does not promise bit-equality across shapes (the JAX package
    asserts it): padded and unpadded runs agree to atol 1e-5 on the valid
    samples, with the padding exactly zero."""
    path, _, _, tokens, cond, _, _ = codec
    cfg, w = load_miocodec(path, CPU)
    n = int(LENGTHS[0])
    outs = []
    for width in (n, 64, 96):
        toks = np.zeros((1, width), np.int32)
        toks[0, :n] = tokens[0, :n]
        audio, ns = codec_synthesize(cfg, w, torch.from_numpy(toks),
                                     torch.tensor([n], dtype=torch.int32),
                                     torch.from_numpy(cond[:1]), matmul="float32")
        k = int(ns[0])
        assert np.all(audio[0, k:].numpy() == 0)
        outs.append(audio[0, :k].numpy())
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=1e-5, rtol=0)


def test_pipeline_synthesize(codec):
    path, _, _, tokens, cond, ref_audio, ref_n = codec
    pipe = MioTTSPipeline(path, CPU)
    res = pipe.synthesize(tokens[0, :LENGTHS[0]], cond[0])
    assert res.audio.shape == (int(ref_n[0]),) and res.n_codes == int(LENGTHS[0])
    np.testing.assert_allclose(res.audio, ref_audio[0, :ref_n[0]], atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        pipe.synthesize([1, 2, 3], None)  # dynamic-global codec needs an embedding


# the wave upsampler at one stage (the 44.1 kHz codec's 2x, kernel 4) and at
# two; samples_per_token keeps each at two decoder frames a token
UPSAMPLERS = {"1-stage": dict(samples_per_token=64, wave_upsampler_factors=(2,),
                              wave_upsampler_kernel_sizes=(4,)),
              "2-stage": dict(samples_per_token=128, wave_upsampler_factors=(2, 2),
                              wave_upsampler_kernel_sizes=(4, 4))}


@pytest.fixture(scope="module", params=list(UPSAMPLERS))
def ups_codec(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ups") / "ups.gguf")
    write_synthetic_miocodec_gguf(path, tiny_codec_config(sample_rate=44100,
                                                          **UPSAMPLERS[request.param]), seed=2)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 128, (2, 64)).astype(np.int32)
    cond = rng.randn(2, 16).astype(np.float32)
    jcfg, jw = jax_load(path)
    return path, jcfg, jw, tokens, cond


def _jax_ups(ups_codec, **kw):
    _, jcfg, jw, tokens, cond = ups_codec
    synth = jax.jit(functools.partial(jax_synthesize, jcfg, **kw))
    audio, n = synth(jax.tree.map(jnp.asarray, jw), jnp.asarray(tokens), jnp.asarray(LENGTHS),
                     jnp.asarray(cond))
    return np.asarray(audio), np.asarray(n)


@pytest.mark.parametrize("source", ["gguf", "jax_tree"])
@pytest.mark.parametrize("kw", [{}, {"interp_anchor_tokens": 40, "peak_normalize": False}],
                         ids=["default", "anchored_unnormalized"])
def test_upsampler_matches_jax(ups_codec, source, kw):
    """A wave codec with an upsampler, loaded from its GGUF and from the JAX
    tree, decodes as JAX's does: the same sample counts, audio within 1e-4
    of its peak where that exceeds 1 (else atol 1e-4), zeros past each
    count. Unnormalized, the random 2-stage codec's spec reaches ~53 and its
    audio ~21, and the packages' f32 differences grow with them (7e-4)."""
    path, jcfg, jw, tokens, cond = ups_codec
    ref, ref_n = _jax_ups(ups_codec, **kw)
    cfg, w = load_miocodec(path, CPU) if source == "gguf" else miocodec_params_from_jax(jcfg, jw,
                                                                                         CPU)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    audio, n = codec_synthesize(cfg, w, torch.from_numpy(tokens), torch.from_numpy(LENGTHS),
                                torch.from_numpy(cond), matmul="float32", **kw)
    f = cfg.wave_upsampler_total_factor
    frames = (LENGTHS * cfg.samples_per_token // cfg.hop_length // f) * f  # k = 2 f, pad f/2
    n_pad = (cfg.n_fft - cfg.hop_length) // 2
    assert np.array_equal(n.numpy(), ref_n)
    assert np.array_equal(ref_n, (frames - 1) * cfg.hop_length + cfg.n_fft - 2 * n_pad)
    np.testing.assert_allclose(audio.numpy(), ref, atol=1e-4 * max(1.0, np.abs(ref).max()),
                               rtol=0)
    for b, k in enumerate(ref_n):
        assert np.all(audio[b, k:].numpy() == 0)
        assert np.all(np.isfinite(audio[b, :k].numpy())) and np.any(audio[b, :k].numpy() != 0)


def test_upsampler_padded_bucket_matches_unpadded(ups_codec):
    """One request alone, unpadded and in two wider buckets: the valid
    samples agree to atol 1e-4 (torch does not promise bit-equality across
    shapes, see test_padded_bucket_matches_unpadded; the 2-stage codec's
    deeper stack differs by up to 1.1e-5), zeros past the count, and they
    match JAX's decode of the batch."""
    path, _, _, tokens, cond = ups_codec
    ref, ref_n = _jax_ups(ups_codec)
    cfg, w = load_miocodec(path, CPU)
    n = int(LENGTHS[1])
    outs = []
    for width in (n, 32, 96):
        toks = np.zeros((1, width), np.int32)
        toks[0, :n] = tokens[1, :n]
        audio, ns = codec_synthesize(cfg, w, torch.from_numpy(toks),
                                     torch.tensor([n], dtype=torch.int32),
                                     torch.from_numpy(cond[1:]), matmul="float32")
        k = int(ns[0])
        assert k == ref_n[1] and np.all(audio[0, k:].numpy() == 0)
        outs.append(audio[0, :k].numpy())
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(outs[0], ref[1, :ref_n[1]], atol=1e-4, rtol=0)


def test_unported_variants_raise(tmp_path):
    """A mel-mode codec without bundled vocoder tensors raises, as in the
    JAX package (the upsampler, which raised here before, is ported: see
    test_upsampler_matches_jax)."""
    path = str(tmp_path / "mel_no_vocoder.gguf")
    write_synthetic_miocodec_gguf(path, tiny_codec_config(model_type=1, n_mels=12,
                                                          resnet_blocks=0))
    with pytest.raises(NotImplementedError, match="MioVocoder"):
        load_miocodec(path, CPU)
