"""The port's codec micro-batcher (miotts_tpu_torch/serving/codec_batching.py):
the cases of tests/test_codec_batching.py against the port's pipeline, and
its audio against the JAX micro-batcher's on the same codes (1e-4). On the
CPU every decode is eager; a group decodes at B = the power of two at or
above its size."""

import concurrent.futures
import time

import numpy as np
import pytest
import torch

from miotts_tpu.pipeline import MioTTSPipeline as JaxPipeline
from miotts_tpu.serving.codec_batching import CodecMicroBatcher as JaxMicroBatcher
from miotts_tpu_torch.pipeline import MioTTSPipeline
from miotts_tpu_torch.runtime.audio_io import encode_pcm16
from miotts_tpu_torch.serving import codec_batching
from miotts_tpu_torch.serving.codec_batching import CodecMicroBatcher
from miotts_tpu_torch.streaming import StreamingSynthesizer
from miotts_tpu_torch.testing import tiny_codec_config, write_synthetic_miocodec_gguf

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("cb")
    cfg = tiny_codec_config()
    write_synthetic_miocodec_gguf(str(d / "codec.gguf"), cfg, seed=0)
    pipe = MioTTSPipeline(str(d / "codec.gguf"), CPU)
    batcher = CodecMicroBatcher(pipe, max_batch=4, gather_window_s=0.02)
    yield pipe, batcher, cfg, str(d / "codec.gguf")
    batcher.shutdown()


def test_single_matches_pipeline(setup):
    pipe, batcher, cfg, _ = setup
    rng = np.random.RandomState(0)
    codes = rng.randint(0, cfg.vocab_size, 20).tolist()
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    a = batcher.synthesize(codes, emb)
    b = pipe.synthesize(codes, emb)
    assert a.audio.size == b.audio.size
    np.testing.assert_allclose(a.audio, b.audio, rtol=1e-4, atol=1e-5)


def test_concurrent_mixed_lengths_match_solo(setup):
    pipe, batcher, cfg, _ = setup
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, cfg.vocab_size, 5 + 7 * i).tolist(),
             rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)) for i in range(4)]
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        results = list(ex.map(lambda r: batcher.synthesize(*r), reqs))
    for (codes, emb), res in zip(reqs, results):
        solo = pipe.synthesize(codes, emb)
        assert res.audio.size == solo.audio.size == len(codes) * cfg.samples_per_token
        np.testing.assert_allclose(res.audio, solo.audio, rtol=1e-4, atol=1e-5)


def test_pcm16_fetch_matches_host_quantization(setup):
    """pcm16=True returns int16 PCM bit-identical to quantizing the f32
    result on the host, with the valid length intact."""
    pipe, batcher, cfg, _ = setup
    rng = np.random.RandomState(2)
    codes = rng.randint(0, cfg.vocab_size, 20).tolist()
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    q = batcher.synthesize(codes, emb, pcm16=True)
    f = batcher.synthesize(codes, emb)
    assert q.audio.dtype == np.int16
    assert q.audio.size == f.audio.size
    assert encode_pcm16(q.audio) == encode_pcm16(f.audio)


def test_validation_errors_propagate(setup):
    pipe, batcher, cfg, _ = setup
    with pytest.raises(ValueError, match="codes are empty"):
        batcher.synthesize([], np.zeros(cfg.decoder_adanorm_dim, np.float32))
    with pytest.raises(ValueError, match="requires embedding"):
        batcher.synthesize([1, 2, 3], None)
    with pytest.raises(ValueError, match="dimension mismatch"):
        batcher.synthesize([1, 2, 3], np.zeros(7, np.float32))


def test_priority_group_runs_first():
    """Groups holding a priority item run first; steady groups keep arrival
    order, and a priority item promotes the group it shares options with
    without reordering inside it."""
    steady_a = ([1], None, ("a",), None, 0, False)
    steady_b = ([1], None, ("b",), None, 0, False)
    prio_c = ([1], None, ("c",), None, 0, True)
    ordered = CodecMicroBatcher._ordered_groups([steady_a, steady_b, prio_c])
    assert [opts for opts, _ in ordered] == [("c",), ("a",), ("b",)]
    steady_c2 = ([2], None, ("c",), None, 0, False)
    ordered = CodecMicroBatcher._ordered_groups([steady_a, steady_c2, prio_c, steady_b])
    assert [opts for opts, _ in ordered] == [("c",), ("a",), ("b",)]
    assert [it[0] for it in ordered[0][1]] == [[2], [1]]


def test_priority_end_to_end_matches_solo(setup):
    pipe, batcher, cfg, _ = setup
    rng = np.random.RandomState(3)
    codes = rng.randint(0, cfg.vocab_size, 12).tolist()
    emb = rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)
    a = batcher.synthesize(codes, emb, priority=True)
    np.testing.assert_allclose(a.audio, pipe.synthesize(codes, emb).audio, rtol=1e-4, atol=1e-5)


def test_streaming_first_feed_passes_priority(setup):
    """The streaming synthesizer flags exactly its first decode as priority
    when its synth_fn takes the keyword."""
    pipe, batcher, cfg, _ = setup
    emb = np.random.RandomState(4).randn(cfg.decoder_adanorm_dim).astype(np.float32)
    seen = []

    def spy_synth(codes, embedding, priority=False, **kw):
        seen.append(bool(priority))
        return batcher.synthesize(codes, embedding, priority=priority, **kw)

    ss = StreamingSynthesizer(pipe, emb, synth_fn=spy_synth, lookahead_tokens=2,
                              min_decode_tokens=2)
    rng2 = np.random.RandomState(5)
    for _ in range(4):
        ss.feed(rng2.randint(0, cfg.vocab_size, 4).tolist())
    ss.finalize()
    assert seen[0] is True and not any(seen[1:])


def test_group_decodes_at_pow2_lanes(setup, monkeypatch):
    """A group of k calls decodes at B = the power of two >= k (not at
    max_batch), pad lanes of one zero code, and each window comes back for
    its own start."""
    pipe, batcher, cfg, _ = setup
    seen = []
    real = pipe.decode

    def spy(tokens, lengths, cond=None, **kw):
        seen.append((tokens.shape[0], list(lengths)))
        return real(tokens, lengths, cond, **kw)

    monkeypatch.setattr(pipe, "decode", spy)
    rng = np.random.RandomState(6)
    items = [(rng.randint(0, cfg.vocab_size, n).tolist(),
              rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)) for n in (9, 14, 30)]
    batch = [(codes, emb, (None, True, False, None), concurrent.futures.Future(), 0, False, 0,
              time.monotonic_ns()) for codes, emb in items]
    batcher._run_group((None, True, False, None), batch)
    assert seen == [(4, [9, 14, 30, 1])]
    for (codes, emb), item in zip(items, batch):
        np.testing.assert_allclose(item[3].result().audio, pipe.synthesize(codes, emb).audio,
                                   rtol=1e-4, atol=1e-5)
    assert [codec_batching._pow2_lanes(k) for k in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]


@pytest.mark.parametrize("opts", [dict(), dict(pcm16=True),
                                  dict(interp_anchor=1024, peak_normalize=False,
                                       window=(256, 1024), pcm16=True)])
def test_audio_matches_jax_micro_batcher(setup, opts):
    """Three concurrent calls through each package's micro-batcher: the
    same audio within 1e-4 (int16 PCM within one step)."""
    pipe, batcher, cfg, path = setup
    jbatcher = JaxMicroBatcher(JaxPipeline(path), max_batch=4, gather_window_s=0.02)
    try:
        rng = np.random.RandomState(7)
        reqs = [(rng.randint(0, cfg.vocab_size, n).tolist(),
                 rng.randn(cfg.decoder_adanorm_dim).astype(np.float32)) for n in (11, 24, 40)]
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            got = list(ex.map(lambda r: batcher.synthesize(*r, **opts), reqs))
            ref = list(ex.map(lambda r: jbatcher.synthesize(*r, **opts), reqs))
    finally:
        jbatcher.shutdown()
    for g, r in zip(got, ref):
        assert g.audio.dtype == r.audio.dtype and g.audio.size == r.audio.size > 0
        assert g.n_total == r.n_total and g.window_start == r.window_start
        tol = 1 if g.audio.dtype == np.int16 else 1e-4
        np.testing.assert_allclose(g.audio.astype(np.float64), r.audio.astype(np.float64),
                                   atol=tol, rtol=0)
