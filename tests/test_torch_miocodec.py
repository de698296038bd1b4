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
                                torch.from_numpy(LENGTHS), torch.from_numpy(cond))
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
                                peak_normalize=False)
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
                                     torch.from_numpy(cond[:1]))
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


def test_unported_variants_raise(tmp_path):
    path = str(tmp_path / "ups.gguf")
    write_synthetic_miocodec_gguf(path, tiny_codec_config(
        samples_per_token=64, wave_upsampler_factors=(2,), wave_upsampler_kernel_sizes=(4,)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_miocodec(path, CPU)
