"""The port's streaming synthesis (miotts_tpu_torch/streaming.py) against
the JAX package's on one tiny codec GGUF, on the CPU.

Both synthesizers, fed the same codes in the same chunks, emit the same
number of samples at every feed, each sample within atol 1e-4 of JAX's (the
codec parity tolerance, tests/test_torch_miocodec.py). A window fetch
matches JAX's window and total count; the port's window and full-fetch
paths are bit-equal; and the latency and monotonicity properties of the
JAX package's own streaming tests hold for the port. The whole slice
(chunked f32 greedy generation feeding the synthesizer) matches JAX's
``stream_text_to_audio``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.models import llm as jllm
from miotts_tpu.models.sampling import SamplerParams as JaxSamplerParams
from miotts_tpu.pipeline import MioTTSPipeline as JaxPipeline
from miotts_tpu.streaming import StreamingSynthesizer as JaxStreamingSynthesizer
from miotts_tpu.streaming import stream_text_to_audio as jax_stream_text_to_audio
from miotts_tpu_torch.models.llm import LLMEngine
from miotts_tpu_torch.models.sampling import SamplerParams
from miotts_tpu_torch.pipeline import MioTTSPipeline
from miotts_tpu_torch.runtime.audio_io import encode_pcm16
from miotts_tpu_torch.streaming import StreamingSynthesizer, stream_text_to_audio
from miotts_tpu_torch.testing import (
    tiny_codec_config, write_synthetic_llm_gguf, write_synthetic_miocodec_gguf)

torch.set_num_threads(1)
CPU = torch.device("cpu")
ATOL = 1e-4


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    cfg = tiny_codec_config()
    write_synthetic_miocodec_gguf(str(d / "codec.gguf"), cfg, seed=0)
    write_synthetic_llm_gguf(str(d / "llm.gguf"), n_audio=cfg.vocab_size, seed=1,
                             audio_logit_scale=3.0)
    return d, JaxPipeline(str(d / "codec.gguf")), MioTTSPipeline(str(d / "codec.gguf"), CPU), cfg


@pytest.fixture(scope="module")
def ups_pipes(tmp_path_factory):
    """The JAX and the port's pipelines on a tiny codec with the 44.1 kHz
    codec's wave upsampler (one 2x stage, kernel 4)."""
    path = str(tmp_path_factory.mktemp("stream_ups") / "codec441.gguf")
    cfg = tiny_codec_config(sample_rate=44100, samples_per_token=64,
                            wave_upsampler_factors=(2,), wave_upsampler_kernel_sizes=(4,))
    write_synthetic_miocodec_gguf(path, cfg, seed=0)
    return JaxPipeline(path), MioTTSPipeline(path, CPU), cfg


def _feed_all(ss, codes, step):
    sizes, pieces = [], []
    for i in range(0, len(codes), step):
        pcm = ss.feed(codes[i:i + step])
        sizes.append(pcm.size)
        pieces.append(pcm)
    tail = ss.finalize()
    sizes.append(tail.size)
    pieces.append(tail)
    return sizes, np.concatenate(pieces)


@pytest.mark.parametrize("step,lookahead,window", [(7, 8, None), (16, 8, None), (5, 4, 512)])
def test_streaming_matches_jax(pipes, step, lookahead, window):
    _, jpipe, pipe, cfg = pipes
    rng = np.random.RandomState(0)
    codes = rng.randint(0, cfg.vocab_size, 60).tolist()
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    jsizes, ref = _feed_all(JaxStreamingSynthesizer(jpipe, emb, lookahead_tokens=lookahead,
                                                    window_samples=window), codes, step)
    sizes, got = _feed_all(StreamingSynthesizer(pipe, emb, lookahead_tokens=lookahead,
                                                window_samples=window), codes, step)
    assert sizes == jsizes and sum(sizes) == len(codes) * cfg.samples_per_token
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("step,window", [(7, None), (16, 512)])
def test_streaming_upsampler_matches_jax(ups_pipes, step, window):
    """The stream on the upsampler codec: JAX's emission sizes, its samples
    within atol 1e-4, at the codec's 44.1 kHz rate."""
    jpipe, pipe, cfg = ups_pipes
    rng = np.random.RandomState(6)
    codes = rng.randint(0, cfg.vocab_size, 60).tolist()
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    jsizes, ref = _feed_all(JaxStreamingSynthesizer(jpipe, emb, window_samples=window), codes,
                            step)
    ss = StreamingSynthesizer(pipe, emb, window_samples=window)
    sizes, got = _feed_all(ss, codes, step)
    assert ss.sample_rate == 44100
    assert sizes == jsizes and sum(sizes) == len(codes) * cfg.samples_per_token
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,start,length", [(40, 0, 512), (40, 900, 512), (60, 1800, 300),
                                            (23, 500, 4096)])
def test_window_synthesize_matches_jax(pipes, n, start, length):
    """synthesize(window=(start, length)) against JAX's: same n_total and
    window start, the same clipped length, samples within the codec
    tolerance; and equal to the full decode's slice."""
    _, jpipe, pipe, cfg = pipes
    rng = np.random.RandomState(n)
    codes = rng.randint(0, cfg.vocab_size, n).tolist()
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    kw = dict(interp_anchor=1024, peak_normalize=False)
    ref = jpipe.synthesize(codes, emb, window=(start, length), **kw)
    got = pipe.synthesize(codes, emb, window=(start, length), **kw)
    assert (got.n_total, got.window_start, got.audio.size) == (ref.n_total, ref.window_start,
                                                               ref.audio.size)
    np.testing.assert_allclose(got.audio, ref.audio, atol=ATOL, rtol=0)
    full = pipe.synthesize(codes, emb, **kw)
    assert full.n_total is None and full.audio.size == got.n_total
    np.testing.assert_array_equal(got.audio, full.audio[start:start + length])


def test_window_fetch_matches_full_fetch(pipes):
    """The port's counterpart of tests/test_streaming.py's: the per-feed
    window fetch emits bit-identical PCM to the full-decode fetch (forced by
    window_samples=1)."""
    _, _, pipe, cfg = pipes
    rng = np.random.RandomState(3)
    codes = rng.randint(0, cfg.vocab_size, 60).tolist()
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    runs = [_feed_all(StreamingSynthesizer(pipe, emb, lookahead_tokens=8, window_samples=w),
                      codes, 7) for w in (512, 1)]
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("n,start,length", [(40, 900, 512), (23, 500, 4096), (60, 0, None)])
def test_pcm16_fetch_is_encode_pcm16(pipes, n, start, length):
    """synthesize(pcm16=True) brings back the 16-bit PCM that
    audio_io.encode_pcm16 makes of the f32 fetch, scaled back to f32, with
    the same counts (a window, and the full fetch when length is None)."""
    _, _, pipe, cfg = pipes
    rng = np.random.RandomState(n)
    codes = rng.randint(0, cfg.vocab_size, n).tolist()
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    kw = dict(interp_anchor=1024, peak_normalize=False,
              window=None if length is None else (start, length))
    ref = pipe.synthesize(codes, emb, **kw)
    got = pipe.synthesize(codes, emb, pcm16=True, **kw)
    assert got.audio.dtype == np.float32
    assert (got.n_total, got.window_start, got.audio.size) == (ref.n_total, ref.window_start,
                                                               ref.audio.size)
    q = np.rint(got.audio * np.float32(32767.0)).astype("<i2")
    assert q.tobytes() == encode_pcm16(ref.audio)


def test_streaming_pcm16_transfer(pipes):
    """transfer_pcm16 streams the same sample counts as f32 transfers, each
    sample within half a 16-bit step (the crossfade mixes two quantized
    windows, so it stays within that bound)."""
    _, _, pipe, cfg = pipes
    rng = np.random.RandomState(4)
    codes = rng.randint(0, cfg.vocab_size, 60).tolist()
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    ref = _feed_all(StreamingSynthesizer(pipe, emb, window_samples=512), codes, 7)
    got = _feed_all(StreamingSynthesizer(pipe, emb, window_samples=512, transfer_pcm16=True),
                    codes, 7)
    assert got[0] == ref[0]
    clipped = np.clip(ref[1], -1.0, 1.0)
    np.testing.assert_allclose(got[1], clipped, atol=0.5 / 32767 + 1e-7, rtol=0)


def test_streaming_incremental_latency(pipes):
    """First audio is ready after lookahead + chunk tokens, not at the end."""
    _, _, pipe, cfg = pipes
    rng = np.random.RandomState(1)
    codes = rng.randint(0, cfg.vocab_size, 40).tolist()
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    ss = StreamingSynthesizer(pipe, emb, lookahead_tokens=4)
    first = ss.feed(codes[:12])
    assert first.size == (12 - 4) * cfg.samples_per_token
    second = ss.feed(codes[12:24])
    assert second.size == 12 * cfg.samples_per_token
    rest = ss.feed(codes[24:])
    tail = ss.finalize()
    assert first.size + second.size + rest.size + tail.size == len(codes) * cfg.samples_per_token


def test_streaming_monotone_no_rewrites(pipes):
    _, _, pipe, cfg = pipes
    rng = np.random.RandomState(2)
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    ss = StreamingSynthesizer(pipe, emb)
    emitted = 0
    for _ in range(6):
        pcm = ss.feed(rng.randint(0, cfg.vocab_size, 9).tolist())
        emitted += pcm.size
        assert ss.emitted == emitted
    tail = ss.finalize()
    assert ss.emitted == emitted + tail.size == 54 * cfg.samples_per_token


def test_streaming_matches_oneshot_tail(pipes):
    """The last emission comes from the full decode: past the crossfade it
    equals the one-shot decode with the same pinned resample ratio."""
    _, _, pipe, cfg = pipes
    rng = np.random.RandomState(0)
    codes = rng.randint(0, cfg.vocab_size, 60).tolist()
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    full = pipe.synthesize(codes, emb, interp_anchor=StreamingSynthesizer.INTERP_ANCHOR,
                           peak_normalize=False).audio
    _, streamed = _feed_all(StreamingSynthesizer(pipe, emb, lookahead_tokens=8), codes, 7)
    assert streamed.size == full.size
    tail = 8 * cfg.samples_per_token - 128
    np.testing.assert_allclose(streamed[-tail:], full[-tail:], rtol=1e-4, atol=1e-5)


def test_stream_text_to_audio_matches_jax(pipes):
    """The slice as a whole: f32 greedy chunked generation feeding the
    synthesizer gives JAX's code count and audio (within the codec
    tolerance), and on_token sees the same tokens."""
    d, jpipe, pipe, cfg = pipes
    rng = np.random.RandomState(5)
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    jeng = jllm.LLMEngine(str(d / "llm.gguf"), dtype=jnp.float32)
    eng = LLMEngine(str(d / "llm.gguf"), CPU, dtype=torch.float32)
    jtoks, toks, jpcm, pcm = [], [], [], []
    ref, jn = jax_stream_text_to_audio(
        jpipe, jeng, "stream this text", emb, n_predict=40,
        sampler=JaxSamplerParams(temp=0.0), on_audio=jpcm.append,
        on_token=lambda t, i, e: jtoks.append(t) or True)
    got, n = stream_text_to_audio(
        pipe, eng, "stream this text", emb, n_predict=40, sampler=SamplerParams(temp=0.0),
        on_audio=pcm.append, on_token=lambda t, i, e: toks.append(t) or True)
    assert toks == jtoks and n == jn > 16
    assert [p.size for p in pcm] == [p.size for p in jpcm]
    assert got.size == n * cfg.samples_per_token
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
