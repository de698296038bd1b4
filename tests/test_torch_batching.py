"""The port's continuous batching against the JAX package: the per-lane
sampler (``sample_token_batched``), the batched chunk API (``attach_lanes``,
``set_lane_done``, the chunk with ``rem``) and the ``ContinuousBatcher``
(miotts_tpu_torch/serving/batching.py) on a tiny f32 GGUF.

Greedy lanes give JAX's tokens exactly. A sampled lane's tokens depend only
on its seed, never on its neighbours: its key is its own and its uniforms
are indexed within its row. The batcher runs the route the card runs: an
``llm.chunk`` per (rung, width) and per fused group size, eager here. The
tests read which chunks exist from its registry (``chunks``, ``_fused``)
and which ran from a spy on ``Chunk.run``."""

import concurrent.futures
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.models import llm as jllm
from miotts_tpu.models import sampling as jsampling
from miotts_tpu_torch.models import decode_graph, llm as llm_mod
from miotts_tpu_torch.models.llm import LLMEngine, load_llm_gguf
from miotts_tpu_torch.models.sampling import (
    MAX_TOP_K, BatchSamplerParams, SamplerParams, SamplerState, sample_token,
    sample_token_batched, sampler_key, sampler_keys, uniform, uniform_lanes)
from miotts_tpu_torch.serving import batching as bmod
from miotts_tpu_torch.serving.batching import ContinuousBatcher
from miotts_tpu_torch.testing import write_synthetic_llm_gguf

torch.set_num_threads(1)
CPU = torch.device("cpu")


# -- the per-lane sampler ---------------------------------------------------------

def _logits_and_ring(B, V=300, seed=0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, V) * 2).astype(np.float32)
    ring = rng.randint(0, V, (B, 64)).astype(np.int32)  # filled rings
    return logits, ring


@pytest.mark.parametrize("top_ps", [(0.9, 0.9, 0.9, 0.9), (1.0, 1.0, 1.0, 1.0), (0.9, 1.0, 0.9, 1.0)])
@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_sample_token_batched_greedy_matches_jax(top_ps, penalty):
    """temp 0, per-lane top_k 0, 1, 50 and 300 (0 and 300 take JAX's
    256-candidate pool), top_p per lane, penalty over filled rings: the
    same tokens as JAX's sample_token_batched."""
    logits, ring = _logits_and_ring(4)
    top_ks = [0, 1, 50, 300]
    jstate = jsampling.SamplerState(ring=jnp.asarray(ring), idx=jnp.int32(64))
    ref = jsampling.sample_token_batched(
        jnp.asarray(logits),
        jsampling.BatchSamplerParams.make([0.0] * 4, top_ks, list(top_ps), [penalty] * 4),
        jstate, jax.random.split(jax.random.PRNGKey(0), 4))
    state = SamplerState(torch.from_numpy(ring).long(), torch.tensor(64, dtype=torch.int32))
    got = sample_token_batched(
        torch.from_numpy(logits),
        BatchSamplerParams.make([0.0] * 4, top_ks, list(top_ps), [penalty] * 4, CPU),
        state, sampler_keys(range(4), CPU))
    assert got.tolist() == np.asarray(ref).tolist()


def test_uniform_lanes_at_b1_is_uniform():
    """Row b of the per-lane uniforms is ``uniform`` of lane b's key alone,
    bit for bit (so at B = 1 the draws are the single-lane sampler's)."""
    keys = torch.tensor([[7, 0], [7, 5], [123456789, 3], [0xFFFFFFFF, 11]], dtype=torch.int64)
    for n in (1, 50, 256):
        got = uniform_lanes(keys, n)
        for b in range(keys.shape[0]):
            assert torch.equal(got[b:b + 1], uniform(keys[b], (1, n)))
            assert torch.equal(uniform_lanes(keys[b:b + 1], n), uniform(keys[b], (1, n)))


def test_set_lane_writes_one_lane():
    """``set_lane`` writes one lane's four settings in place (the chunk
    graphs' static buffers) and leaves its neighbours'; a top_k <= 0 is
    stored as 0 and one above the pool as MAX_TOP_K, both the whole pool."""
    params = BatchSamplerParams.make([0.8] * 3, [50] * 3, [1.0] * 3, [1.0] * 3, CPU)
    tensors = [params.temp, params.top_k, params.top_p, params.repeat_penalty]
    params.set_lane(1, SamplerParams(temp=0.3, top_k=300, top_p=0.9, repeat_penalty=1.3))
    params.set_lane(2, SamplerParams(temp=0.0, top_k=-4, top_p=0.5, repeat_penalty=1.1))
    assert all(a is b for a, b in zip(
        (params.temp, params.top_k, params.top_p, params.repeat_penalty), tensors))
    assert params.temp.tolist() == pytest.approx([0.8, 0.3, 0.0])
    assert params.top_k.tolist() == [50, MAX_TOP_K, 0]
    assert params.top_p.tolist() == pytest.approx([1.0, 0.9, 0.5])
    assert params.repeat_penalty.tolist() == pytest.approx([1.0, 1.3, 1.1])


@pytest.mark.parametrize("top_k", [1, 5, 50, MAX_TOP_K])
@pytest.mark.parametrize("top_p,penalty", [(1.0, 1.0), (0.9, 1.3)])
def test_batched_lane_picks_what_sample_token_picks(top_k, top_p, penalty):
    """Sampled (temp 0.8), 20 draws in a row: a lane of the batched chain
    picks exactly what ``sample_token`` picks from the same logits, ring and
    key whenever top_k <= 256, alone and among neighbours with other
    settings and seeds."""
    logits, ring = _logits_and_ring(3, seed=2)
    sampler = SamplerParams(temp=0.8, top_k=top_k, top_p=top_p, repeat_penalty=penalty)
    batched = BatchSamplerParams.make([0.8, 1.0, 0.5], [top_k, 7, 0], [top_p, 0.8, 1.0],
                                      [penalty, 1.1, 1.0], CPU)
    keys = sampler_keys([9, 1, 2], CPU)
    ring_t = torch.from_numpy(ring).long()
    state = SamplerState(ring_t, torch.tensor(64, dtype=torch.int32))
    alone_params = BatchSamplerParams.make([0.8], [top_k], [top_p], [penalty], CPU)
    for _ in range(20):
        single = sample_token(torch.from_numpy(logits[:1]), sampler,
                              SamplerState(ring_t[:1], state.idx), keys[0])
        alone = sample_token_batched(torch.from_numpy(logits[:1]), alone_params,
                                     SamplerState(ring_t[:1], state.idx), keys[:1])
        among = sample_token_batched(torch.from_numpy(logits), batched, state, keys)
        assert int(single[0]) == int(alone[0]) == int(among[0])
        keys[:, 1] += 1


# -- the batched chunk API against JAX ---------------------------------------------

@pytest.fixture(scope="module")
def tiny_llm(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("llm") / "tiny_llm.gguf")
    write_synthetic_llm_gguf(path, n_audio=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                             ffn=64, seed=0)
    return path


def _group(rows, lens, kp, bucket, n_lanes, seed=0):
    rng = np.random.RandomState(seed)
    toks = np.zeros((kp, bucket), np.int32)
    lengths = np.ones(kp, np.int32)
    lanes = np.full(kp, n_lanes, np.int32)
    for i, (lane, n) in enumerate(zip(rows, lens)):
        toks[i, :n] = rng.randint(0, 300, n)
        lengths[i] = n
        lanes[i] = lane
    return toks, lengths, lanes


def test_attach_chunk_and_lane_done_match_jax(tiny_llm):
    """Greedy f32 over 3 of 4 lanes with prompt lengths 11, 5 and 17 and
    budgets 9, 14 and 20 (lane 1 with repeat penalty 1.3), in chunks of 6
    steps with ``rem``; after the second chunk lane 2 is set done and a
    fourth prompt attaches to lane 3. Tokens, n_new, done and pos equal
    JAX's attach_lanes / set_lane_done / llm_generate_chunk_batched after
    every chunk (the port's: one ``llm.chunk`` run again and again)."""
    jcfg, jw, _ = jllm.load_llm_gguf(tiny_llm, dtype=jnp.float32)
    cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.float32)
    B, S, steps = 4, 64, 6
    eog = [-1]
    jstate = jllm.init_batched_state(jcfg, B, S)
    state = llm_mod.init_batched_state(cfg, B, S, CPU)
    assert bool(state.done.all()) and tuple(state.key.shape) == (B, 2)
    pens = [1.0, 1.3, 1.0, 1.0]
    jsampler = jsampling.BatchSamplerParams.make([0.0] * B, [50] * B, [1.0] * B, pens)
    sampler = BatchSamplerParams.make([0.0] * B, [50] * B, [1.0] * B, pens, CPU)

    def attach(rows, lens, seeds, seed):
        nonlocal jstate
        kp = 1 << max(0, len(rows) - 1).bit_length()
        toks, lengths, lanes = _group(rows, lens, kp, 32, B, seed)
        seeds = np.array(list(seeds) + [0] * (kp - len(seeds)), np.uint32)
        jl, jk, jv = jllm.llm_prefill_kv(jcfg, jw, jnp.asarray(toks), jnp.asarray(lengths))
        jstate = jllm.attach_lanes(jstate, jnp.asarray(lanes), jl, jk, jv,
                                   jnp.asarray(lengths), jnp.asarray(seeds))
        lg, k, v = llm_mod.llm_prefill_kv(cfg, w, torch.from_numpy(toks).long(),
                                          torch.from_numpy(lengths))
        llm_mod.attach_lanes(state, lanes, lg, k, v, lengths, seeds)

    attach([0, 1, 2], [11, 5, 17], [1, 2, 3], seed=0)
    rem_t = torch.zeros(B, dtype=torch.int32)
    ch = llm_mod.chunk(cfg, w, torch.tensor(eog), steps, sampler, state, rem=rem_t)
    budgets = np.array([9, 14, 20, 0], np.int32)
    sent = np.zeros(B, np.int32)
    for i in range(4):
        if i == 2:
            jstate = jllm.set_lane_done(jstate, jnp.int32(2))
            llm_mod.set_lane_done(state, 2)
            attach([3], [9], [4], seed=1)
            budgets[3] = 10
            sent[3] = 0
        rem = np.maximum(0, budgets - sent).astype(np.int32)
        jout, jn, jstate = jllm.llm_generate_chunk_batched(
            jcfg, jw, jnp.asarray(eog, jnp.int32), steps, jsampler, jstate,
            jnp.asarray(steps, jnp.int32), jnp.asarray(rem))
        jo, jn_np, jdone = jllm.fetch_chunk_result(jout, jn, jstate)
        rem_t.copy_(torch.from_numpy(rem))
        out, n_new = ch.run()
        o, n_np, done = llm_mod.fetch_chunk_result(out, n_new, state)
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(n_np, jn_np)
        np.testing.assert_array_equal(done, jdone)
        np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
        sent += steps
    assert list(done) == [True] * 4


def test_attach_drops_pad_rows_and_resets_lane(tiny_llm):
    """A pad row (lane == B) writes nothing; an attached lane gets its
    prompt's K/V in [0, T), pos T, an empty ring, done False and (seed, 0)."""
    cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.float32)
    state = llm_mod.init_batched_state(cfg, 3, 40, CPU)
    state.ring.fill_(5)
    before = state.cache_k.clone()
    toks, lengths, lanes = _group([1], [7], 2, 32, 3)
    lg, k, v = llm_mod.llm_prefill_kv(cfg, w, torch.from_numpy(toks).long(),
                                      torch.from_numpy(lengths))
    llm_mod.attach_lanes(state, lanes, lg, k, v, lengths, [77, 0])
    assert state.done.tolist() == [True, False, True]
    assert state.pos[1] == 7 and state.key[1].tolist() == [77, 0]
    assert (state.ring[1] == -1).all() and (state.ring[0] == 5).all()
    assert torch.equal(state.cache_k[:, 1, :32], k[:, 0].to(torch.bfloat16))
    assert torch.equal(state.cache_k[:, [0, 2]], before[:, [0, 2]])
    assert torch.equal(state.logits[1], lg[0])


# -- the ContinuousBatcher ----------------------------------------------------------

@pytest.fixture(scope="module")
def batcher(tmp_path_factory):
    path = tmp_path_factory.mktemp("cb") / "llm.gguf"
    write_synthetic_llm_gguf(str(path), n_audio=64, seed=0)
    eng = LLMEngine(str(path), CPU, dtype=torch.float32)
    b = ContinuousBatcher(eng, n_lanes=4, max_ctx=128, chunk=8)
    yield eng, b, str(path)
    b.shutdown()


@pytest.fixture(scope="module")
def jax_engine(batcher):
    return jllm.LLMEngine(batcher[2], dtype=jnp.float32)


def _own(eng, **kw):
    return ContinuousBatcher(eng, **{"n_lanes": 2, "max_ctx": 160, "chunk": 8, "seed": 0, **kw})


def _spy_runs(monkeypatch) -> list:
    """The chunks that run from now on (``Chunk.run``), in order."""
    ran = []
    real = decode_graph.Chunk.run

    def run(self):
        ran.append(self)
        return real(self)

    monkeypatch.setattr(decode_graph.Chunk, "run", run)
    return ran


def _worker_steps(b, ran) -> list[int]:
    """The steps of the worker's chunks among ``ran`` (the fused chunks
    have states of their own)."""
    return [ch.n_steps for ch in ran if ch.state is b.state]


def test_single_request(batcher):
    eng, b, _ = batcher
    toks = b.submit("hello", SamplerParams(temp=0.8, seed=1), n_predict=20).collect()
    assert 0 < len(toks) <= 20
    assert all(0 <= t < len(eng.tokenizer.tokens) for t in toks)


@pytest.mark.parametrize("text,n_predict", [("hi there", 12), ("hi", 40)])
def test_greedy_matches_jax_engine(batcher, jax_engine, text, n_predict):
    """A greedy lane's tokens equal JAX LLMEngine.generate_audio_tokens and
    the port's own single-request path."""
    eng, b, _ = batcher
    expect = jax_engine.generate_audio_tokens(text, n_predict=n_predict, n_ctx=64,
                                              sampler=jsampling.SamplerParams(temp=0.0))
    got = b.submit(text, SamplerParams(temp=0.0), n_predict=n_predict).collect()
    assert got == expect
    assert got == eng.generate_audio_tokens(text, n_predict=n_predict, n_ctx=64,
                                            sampler=SamplerParams(temp=0.0))


def test_concurrent_mixed_requests(batcher, jax_engine):
    eng, b, _ = batcher

    def one(i):
        sampler = SamplerParams(temp=0.0 if i % 2 == 0 else 0.9, top_k=0 if i % 2 == 0 else 40)
        return b.submit(f"request {i}", sampler, n_predict=10 + i).collect()

    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        results = list(ex.map(one, range(6)))
    for i, toks in enumerate(results):
        assert 0 < len(toks) <= 10 + i
    # greedy lanes stay deterministic under concurrency
    expect = jax_engine.generate_audio_tokens("request 0", n_predict=10, n_ctx=64,
                                              sampler=jsampling.SamplerParams(temp=0.0))
    assert results[0] == expect[:len(results[0])]


def test_burst_submits_coalesce_and_match_single_path(batcher):
    """A barrier-released burst flows through the coalescing prefill thread
    (one grouped forward or several, by drain timing, across prompt
    buckets) and greedy results equal the single-request path."""
    eng, b, _ = batcher
    texts = ["a", "bb longer prompt that still fits", "ccc", "d" * 40]
    barrier = threading.Barrier(len(texts))

    def one(text):
        barrier.wait()
        return b.submit(text, SamplerParams(temp=0.0), n_predict=10).collect()

    with concurrent.futures.ThreadPoolExecutor(len(texts)) as ex:
        results = list(ex.map(one, texts))
    for text, got in zip(texts, results):
        assert got == eng.generate_audio_tokens(text, n_predict=10, n_ctx=64,
                                                sampler=SamplerParams(temp=0.0)), text


def test_lane_reuse_after_completion(batcher):
    eng, b, _ = batcher
    for round_ in range(3):
        hs = [b.submit(f"round {round_} req {i}", SamplerParams(temp=0.5), n_predict=6)
              for i in range(4)]
        assert all(0 < len(h.collect()) <= 6 for h in hs)
    assert all(lane is None for lane in b.lanes)


def test_budget_exact_cut(batcher):
    eng, b, _ = batcher
    assert len(b.submit("budget", SamplerParams(temp=0.7, seed=2), n_predict=5).collect()) <= 5


def test_per_lane_seed_reproducibility(batcher):
    """Same seed => identical tokens whatever its lane neighbours (bit-equal
    among three concurrent sampled requests of other seeds); another seed
    => other tokens."""
    eng, b, _ = batcher
    sp42 = SamplerParams(temp=0.9, seed=42)
    a = b.submit("seed test", sp42, n_predict=24).collect()
    noise = [b.submit(f"noise {i}", SamplerParams(temp=1.0, seed=100 + i), n_predict=24)
             for i in range(3)]
    c = b.submit("seed test", sp42, n_predict=24).collect()
    for h in noise:
        h.collect()
    assert a == c
    assert b.submit("seed test", SamplerParams(temp=0.9, seed=43), n_predict=24).collect() != a


def test_prompt_too_long_rejected(batcher):
    eng, b, _ = batcher
    with pytest.raises(ValueError, match="prompt is too long"):
        b.submit("x" * 4000, SamplerParams(), n_predict=4)


def test_worker_survives_chunk_failure(batcher, monkeypatch):
    """A failure mid-chunk fails the in-flight requests (raise, not hang)
    and leaves the worker serving later submits."""
    eng = batcher[0]
    b = _own(eng)
    try:
        real = b._chunk
        calls = {"n": 0}

        def boom(*a, **k):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected device failure")
            return real(*a, **k)

        monkeypatch.setattr(b, "_chunk", boom)
        # n_predict beyond first_chunk: the fused prefill serves the first
        # tokens, and the failure targets the worker's chunk
        with pytest.raises(RuntimeError, match="injected device failure"):
            b.submit("fail me", n_predict=40).collect()
        assert len(b.submit("works again", n_predict=40).collect()) > 0
    finally:
        b.shutdown()


def test_prefill_thread_survives_group_failure(batcher, monkeypatch):
    """An exception escaping _prefill_group fails that group's requests
    and the prefill thread keeps draining."""
    eng = batcher[0]
    b = _own(eng)
    try:
        real = b._prefill_group
        calls = {"n": 0}

        def boom(bucket, group):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected upload failure")
            return real(bucket, group)

        monkeypatch.setattr(b, "_prefill_group", boom)
        with pytest.raises(RuntimeError, match="injected upload failure"):
            b.submit("fail in prefill", n_predict=8).collect()
        assert len(b.submit("works again", n_predict=8).collect()) > 0
        assert any(lane is None for lane in b.lanes)
    finally:
        b.shutdown()


def test_prefill_thread_survives_finish_failure(batcher, monkeypatch):
    """A failing finish closure (the delivery after the prefill) fails only
    its group; the thread lives and the lane is freed (the reference's
    unguarded finish loop lost the thread)."""
    eng = batcher[0]
    b = _own(eng)
    try:
        real = b._prefill_group
        calls = {"n": 0}

        def broken_finish(bucket, group):
            fins = real(bucket, group)
            calls["n"] += 1
            if calls["n"] == 1:
                def fail():
                    raise RuntimeError("injected delivery failure")
                return [fail]
            return fins

        monkeypatch.setattr(b, "_prefill_group", broken_finish)
        with pytest.raises(RuntimeError, match="injected delivery failure"):
            b.submit("fail in finish", n_predict=8).collect()
        assert b._prefill_thread.is_alive()
        assert len(b.submit("works again", n_predict=8).collect()) > 0
        assert all(lane is None for lane in b.lanes)
    finally:
        b.shutdown()


def _attach_failure(batcher, monkeypatch, fused):
    eng = batcher[0]
    if not fused:
        monkeypatch.setenv("MIOTTS_FUSED_PREFILL", "0")
    b = _own(eng)
    try:
        real = bmod.attach_group
        calls = {"n": 0}

        def boom(state, *args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected attach failure")
            return real(state, *args, **kwargs)

        monkeypatch.setattr(bmod, "attach_group", boom)
        with pytest.raises(RuntimeError, match="injected attach failure"):
            b.submit("fail in attach", n_predict=8).collect()
        assert len(b.submit("works again", n_predict=8).collect()) > 0
    finally:
        b.shutdown()


def test_worker_survives_attach_failure(batcher, monkeypatch):
    """A failed attach (``attach_group`` of a fused group) fails only that
    group; the worker keeps serving."""
    _attach_failure(batcher, monkeypatch, True)


def test_worker_survives_unfused_attach_failure(batcher, monkeypatch):
    """The same with MIOTTS_FUSED_PREFILL=0 (``attach_group`` of a
    ``prefilled`` group)."""
    _attach_failure(batcher, monkeypatch, False)


def test_device_stall_watchdog(batcher):
    eng = batcher[0]
    b = _own(eng)
    try:
        assert not b.device_stalled
        assert len(b.submit("watchdog", n_predict=8).collect()) > 0
        assert not b.device_stalled
        b.stall_threshold_s = 0.05
        b._work_started = time.monotonic() - 1.0
        b._last_progress = time.monotonic() - 1.0
        assert b.device_stalled
        b._work_started = None
        assert not b.device_stalled
        assert b.stall_events == 0 and b.longest_fetch_s >= 0.0
    finally:
        b.shutdown()


@pytest.mark.parametrize("early,first_chunk,expect", [
    # a streaming lane: the TTFA-first chunk, then (solo, uncontended)
    # chunk_max, and the last budget-shrunk dispatch runs the rung above it
    (True, 4, [4, 16, 4]),
    # a binary lane votes chunk_max outright; the remaining 8 runs rung 8
    (False, 4, [16, 8]),
])
def test_graph_per_rung_matches_eager(batcher, monkeypatch, early, first_chunk, expect):
    """Unfused and at full width: one chunk per ladder size over one shared
    state (the chunks the card captures), each dispatch runs the smallest
    rung at or above its size, and the tokens equal the single-request
    path's."""
    eng = batcher[0]
    monkeypatch.setenv("MIOTTS_FUSED_PREFILL", "0")
    monkeypatch.setenv("MIOTTS_CHUNK_SLICE", "0")
    b = _own(eng, first_chunk=first_chunk)
    try:
        assert b.ladder == (first_chunk, 8, 16) and b.widths() == [b.n_lanes]
        for rung in b.ladder:
            b.warm_chunk(rung)
        assert list(b.chunks) == [(first_chunk, 2), (8, 2), (16, 2)]
        assert all(ch.state is b.state and not ch.captured for ch in b.chunks.values())
        ran = _spy_runs(monkeypatch)
        got = b.submit("hi", SamplerParams(temp=0.0), n_predict=24, early_tokens=early).collect()
        steps = _worker_steps(b, ran)
    finally:
        b.shutdown()
    assert got == eng.generate_audio_tokens("hi", n_predict=24, n_ctx=64,
                                            sampler=SamplerParams(temp=0.0))
    if len(got) == 24:  # no early EOG: the walk is fixed
        assert steps == expect


def test_contended_lanes_keep_middle_rung(batcher, monkeypatch):
    """Two streaming requests in flight: the middle rung (8) stays in use."""
    eng = batcher[0]
    ran = _spy_runs(monkeypatch)
    b = _own(eng)
    try:
        h1 = b.submit("hi", SamplerParams(temp=0.0), n_predict=40)
        h2 = b.submit("hi there", SamplerParams(temp=0.0), n_predict=40)
        got1, got2 = h1.collect(), h2.collect()
        sizes = _worker_steps(b, ran)
    finally:
        b.shutdown()
    assert got1 == eng.generate_audio_tokens("hi", n_predict=40, n_ctx=64,
                                             sampler=SamplerParams(temp=0.0))
    assert len(got2) > 0 and set(sizes) <= {8, 16}
    if len(got1) == 40:
        assert 8 in sizes


def test_ladder_env_knobs(batcher, monkeypatch):
    """MIOTTS_CHUNK_STEPS, MIOTTS_FIRST_CHUNK and MIOTTS_CHUNK_MAX choose
    the ladder, and with it which graphs exist."""
    eng = batcher[0]
    monkeypatch.setenv("MIOTTS_CHUNK_STEPS", "6")
    monkeypatch.setenv("MIOTTS_FIRST_CHUNK", "3")
    monkeypatch.setenv("MIOTTS_CHUNK_MAX", "6")
    b = _own(eng)
    try:
        assert (b.first_chunk, b.chunk, b.chunk_max, b.ladder) == (3, 6, 6, (3, 6))
        assert [b._rung(s) for s in (1, 3, 4, 6)] == [3, 3, 6, 6]
        got = b.submit("hi", SamplerParams(temp=0.0), n_predict=20).collect()
    finally:
        b.shutdown()
    assert got == eng.generate_audio_tokens("hi", n_predict=20, n_ctx=64,
                                            sampler=SamplerParams(temp=0.0))


# -- width-sliced chunks and the fused prefill against JAX --------------------------

def _attach_both(jcfg, jw, cfg, w, jstate, state, rows, lens, seeds, n_lanes, seed):
    kp = 1 << max(0, len(rows) - 1).bit_length()
    toks, lengths, lanes = _group(rows, lens, kp, 32, n_lanes, seed)
    seeds = np.array(list(seeds) + [0] * (kp - len(seeds)), np.uint32)
    jl, jk, jv = jllm.llm_prefill_kv(jcfg, jw, jnp.asarray(toks), jnp.asarray(lengths))
    jstate = jllm.attach_lanes(jstate, jnp.asarray(lanes), jl, jk, jv, jnp.asarray(lengths),
                               jnp.asarray(seeds))
    lg, k, v = llm_mod.llm_prefill_kv(cfg, w, torch.from_numpy(toks).long(),
                                      torch.from_numpy(lengths))
    llm_mod.attach_lanes(state, lanes, lg, k, v, lengths, seeds)
    return jstate


@pytest.mark.parametrize("penalty", [1.0, 1.1])
def test_sliced_chunk_matches_jax_and_leaves_other_lanes(tiny_llm, penalty):
    """Greedy f32, 8 lanes, lanes 0, 3, 5 and 6 live: a width-4 chunk over
    lanes 0, 3 and 5 (JAX pads with lane 8; the port with the distinct free
    lane 1, written 8 + 1) gives JAX's sliced tokens, n_new, done, pos and
    ring on the gathered lanes, their logits and cache within tolerance,
    the full-width chunk's tokens on them, and leaves lane 6 (live, outside
    the slice) and every other lane but the pad exactly as it was."""
    jcfg, jw, _ = jllm.load_llm_gguf(tiny_llm, dtype=jnp.float32)
    cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.float32)
    B, S, steps = 8, 64, 6
    jstate = jllm.init_batched_state(jcfg, B, S)
    state = llm_mod.init_batched_state(cfg, B, S, CPU)
    pens = [penalty] * B
    jsampler = jsampling.BatchSamplerParams.make([0.0] * B, [50] * B, [1.0] * B, pens)
    sampler = BatchSamplerParams.make([0.0] * B, [50] * B, [1.0] * B, pens, CPU)
    jstate = _attach_both(jcfg, jw, cfg, w, jstate, state, [0, 3, 5, 6], [11, 5, 17, 9],
                          [1, 2, 3, 4], B, 0)
    full = llm_mod.GenState(*(t.clone() for t in (
        state.logits, state.cache_k, state.cache_v, state.pos, state.ring, state.ring_idx,
        state.done, state.key)))
    eog = [-1]
    rem = np.array([20, 0, 0, 3, 0, 20, 20, 0], np.int32)
    rem_t = torch.zeros(B, dtype=torch.int32)
    sliced = llm_mod.chunk(cfg, w, torch.tensor(eog), steps, sampler, state, rem=rem_t,
                           lanes=torch.tensor([0, 3, 5, B + 1]))
    full_chunk = llm_mod.chunk(cfg, w, torch.tensor(eog), steps, sampler, full, rem=rem_t)
    for chunk in range(2):
        before = {k: v.clone() for k, v in vars(state).items()}
        jout, jn, jstate = jllm.llm_generate_chunk_batched_sliced(
            jcfg, jw, jnp.asarray(eog, jnp.int32), steps, 4, jsampler, jstate,
            jnp.asarray([0, 3, 5, 8], jnp.int32), jnp.asarray(steps, jnp.int32),
            jnp.asarray(rem))
        jo, jn_np, jdone = jllm.fetch_chunk_result(jout, jn, jstate)
        rem_t.copy_(torch.from_numpy(rem))
        out, n_new = sliced.run()
        o, n_np, done = llm_mod.fetch_chunk_result(out, n_new, state)
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(n_np, jn_np)
        live = [0, 3, 5]
        np.testing.assert_array_equal(done[live], jdone[live])
        np.testing.assert_array_equal(state.pos.numpy()[live], np.asarray(jstate.pos)[live])
        np.testing.assert_array_equal(state.ring.numpy()[live], np.asarray(jstate.ring)[live])
        assert int(state.ring_idx) == int(jstate.ring_idx)
        np.testing.assert_allclose(state.logits.numpy()[live], np.asarray(jstate.logits)[live],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(state.cache_k.float().numpy()[:, live],
                                   np.asarray(jstate.cache_k.astype(jnp.float32))[:, live],
                                   rtol=2e-2, atol=2e-2)
        for lane in (2, 4, 6, 7):  # outside the slice (6 live), and not the pad
            for name, t in vars(state).items():
                if name == "ring_idx":
                    continue
                dim = 1 if name.startswith("cache") else 0
                assert torch.equal(t.select(dim, lane), before[name].select(dim, lane)), (
                    name, lane)
        # the full-width chunk gives the gathered lanes the same tokens
        fo, _fn = full_chunk.run()
        np.testing.assert_array_equal(fo.numpy()[live], o[live])
        rem = np.maximum(0, rem - n_np).astype(np.int32)


def _fused(cfg, w, eog, n, toks, lengths, seeds, sampler, S=64):
    """The batcher's fused route: ``prefill_into`` a k-lane state of S
    rows, one run of an unbudgeted n-step chunk on it, and the group state
    of its first T + n rows. Returns (out, n_new, group state)."""
    k = toks.shape[0]
    st = llm_mod.prefill_into(cfg, w, torch.from_numpy(toks).long(), torch.from_numpy(lengths),
                              seeds, llm_mod.fused_state(cfg, k, S, CPU))
    out, n_new = llm_mod.chunk(cfg, w, torch.tensor(eog), n, sampler, st,
                               rem=torch.full((k,), llm_mod.NO_BUDGET, dtype=torch.int32)).run()
    return out, n_new, st.head(toks.shape[1] + n)


@pytest.mark.parametrize("penalty", [1.0, 1.1])
def test_fused_prefill_and_attach_match_jax(tiny_llm, penalty):
    """Greedy f32: the fused prefill + 5 steps of a padded group of 3 (k =
    4; prompts 11, 5 and 17 long) gives JAX's llm_prefill_generate_jit
    tokens, n_new, done, pos, ring and key, its logits and cache rows within
    tolerance (the port's steps run on a state of 64 cache rows, JAX's on
    its mini state of 32 + 5); ``attach_group`` (JAX's attach_lanes_gen)
    into lanes 2, 0 and 3 of a 4-lane state and two more chunks give JAX's
    tokens (at penalty 1.1 the ring crosses the attach with its entries at
    mini-loop positions, as in JAX)."""
    jcfg, jw, _ = jllm.load_llm_gguf(tiny_llm, dtype=jnp.float32)
    cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.float32)
    toks, lengths, lanes = _group([2, 0, 3], [11, 5, 17], 4, 32, 4, seed=3)
    seeds = np.array([5, 6, 7, 0], np.uint32)
    n, eog = 5, [-1]
    pens = [penalty] * 4
    jout, jn, jg = jllm.llm_prefill_generate_jit(
        jcfg, jw, jnp.asarray(eog, jnp.int32), n, jnp.asarray(toks), jnp.asarray(lengths),
        jnp.asarray(seeds), jsampling.BatchSamplerParams.make([0.0] * 4, [50] * 4, [1.0] * 4,
                                                              pens))
    out, n_new, g = _fused(cfg, w, eog, n, toks, lengths, seeds,
                           BatchSamplerParams.make([0.0] * 4, [50] * 4, [1.0] * 4, pens, CPU))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n_new.numpy(), np.asarray(jn))
    for name in ("pos", "done", "ring"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(jg, name)))
    assert g.cache_k.shape[2] == jg.cache_k.shape[2] == 32 + n
    np.testing.assert_allclose(g.logits.numpy(), np.asarray(jg.logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g.cache_v.float().numpy(),
                               np.asarray(jg.cache_v.astype(jnp.float32)), rtol=2e-2, atol=2e-2)

    B, S = 4, 64
    jstate = jllm.init_batched_state(jcfg, B, S)
    state = llm_mod.init_batched_state(cfg, B, S, CPU)
    jstate = jllm.attach_lanes_gen(jstate, jnp.asarray(lanes), jg)
    llm_mod.attach_group(state, lanes, g)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    np.testing.assert_array_equal(state.ring.numpy(), np.asarray(jstate.ring))
    assert state.done.tolist() == [False, True, False, False]
    jsampler = jsampling.BatchSamplerParams.make([0.0] * B, [50] * B, [1.0] * B, pens)
    sampler = BatchSamplerParams.make([0.0] * B, [50] * B, [1.0] * B, pens, CPU)
    rem = np.full(B, 30, np.int32)
    ch = llm_mod.chunk(cfg, w, torch.tensor(eog), 6, sampler, state, rem=torch.from_numpy(rem))
    for _ in range(2):
        jo, jn2, jstate = jllm.llm_generate_chunk_batched(
            jcfg, jw, jnp.asarray(eog, jnp.int32), 6, jsampler, jstate,
            jnp.asarray(6, jnp.int32), jnp.asarray(rem))
        o, n2 = ch.run()
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(n2.numpy(), np.asarray(jn2))


def test_attach_lanes_gen_drops_pad_rows(tiny_llm):
    """A fused row whose lane is out of range writes nothing
    (``attach_group``); the others take the group state's rows
    mid-generation, and the ring cursor stays the batched state's."""
    cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.float32)
    toks, lengths, lanes = _group([1], [7], 2, 32, 3)
    sampler = BatchSamplerParams.make([0.0] * 2, [50] * 2, [1.0] * 2, [1.0] * 2, CPU)
    _out, _n, g = _fused(cfg, w, [-1], 4, toks, lengths, [9, 0], sampler)
    state = llm_mod.init_batched_state(cfg, 3, 64, CPU)
    state.ring_idx.fill_(17)
    before = {k: v.clone() for k, v in vars(state).items()}
    llm_mod.attach_group(state, lanes, g)
    assert state.pos[1] == 7 + 4 and not state.done[1] and int(state.ring_idx) == 17
    assert state.key[1].tolist() == [9, 4]
    assert torch.equal(state.cache_k[:, 1, :36], g.cache_k[:, 0])
    for name in ("logits", "pos", "ring", "done", "key"):
        assert torch.equal(getattr(state, name)[[0, 2]], before[name][[0, 2]]), name


# -- the batcher's slicing, fused prefill, warm registries, hold and depth ------------

def test_width_sliced_chunk_used_and_identical(batcher, jax_engine, monkeypatch):
    """Below full occupancy the worker dispatches the width-sliced chunk
    and the tokens equal JAX's engine and the port's single-request path;
    the full-width chunk never runs for a lone request on a 4-lane batcher;
    a sampled lane is seed-reproducible through the sliced path."""
    eng, b, _ = batcher
    assert b.slice_chunks
    ran = _spy_runs(monkeypatch)
    got = b.submit("slice me", SamplerParams(temp=0.0), n_predict=24).collect()
    widths = [key[1] for c in ran for key, ch in b.chunks.items() if ch is c]
    assert all(tuple(b.ranks[0].lanes_bufs[wd].shape) == (wd,) for wd in widths)
    assert got == jax_engine.generate_audio_tokens("slice me", n_predict=24, n_ctx=64,
                                                   sampler=jsampling.SamplerParams(temp=0.0))
    assert got == eng.generate_audio_tokens("slice me", n_predict=24, n_ctx=64,
                                            sampler=SamplerParams(temp=0.0))
    assert widths and set(widths) == {1}
    assert len(widths) == len(_worker_steps(b, ran))  # every worker chunk sliced, none full
    s = SamplerParams(temp=0.9, top_k=40, seed=7)
    assert b.submit("vary", s, n_predict=20).collect() == b.submit("vary", s, n_predict=20).collect()


def test_pick_width_warm_gate(batcher):
    """An unwarmed width falls back to the next warm power of two, then to
    the full width; while the warm-up tail runs (split_cold_until_warm)
    nothing new is captured."""
    b = batcher[1]
    assert b._pick_width(8, 0) is None
    assert b._pick_width(8, 5) is None  # pow2(5) = 8 >= n_lanes = 4: full
    saved = (b.split_cold_until_warm, b._warm_chunks)
    try:
        b.split_cold_until_warm = True
        b._warm_chunks = frozenset({(8, 2)})
        assert b._pick_width(8, 1) == 2
        assert b._pick_width(8, 2) == 2
        assert b._pick_width(8, 3) is None
        assert b._pick_width(16, 1) is None
        b.split_cold_until_warm = False
        assert b._pick_width(8, 1) == 2
        assert b._pick_width(16, 1) == 1
        b._warm_chunks = frozenset({(8, b.n_lanes)})
        assert b._pick_width(8, 1) is None
    finally:
        b.split_cold_until_warm, b._warm_chunks = saved


def test_warm_chunk_registers_and_releases(batcher):
    """warm_chunk makes the chunk of (size, width) on the live state and
    registers it (the full width for None); a throwaway state is made only
    for a capture (none on the CPU), and release_warm_state drops it."""
    b = batcher[1]
    b.warm_chunk(width=2)
    b.warm_chunk()
    keys = {(b.chunk_max, 2), (b.chunk_max, b.n_lanes)}
    assert keys <= set(b._warm_chunks) and keys <= set(b.chunks)
    assert all(b.chunks[k].state is b.state and not b.chunks[k].captured for k in keys)
    assert b._warm_state is None
    with b.ranks[0].capture_lock:
        ws = b._warm_state_now(b.ranks[0])
    assert b._warm_state is ws and ws.pos is not b.state.pos
    b.release_warm_state()
    assert b._warm_state is None


def test_unfused_prefill_fallback(batcher, monkeypatch):
    """MIOTTS_FUSED_PREFILL=0 is the unfused path with the same greedy
    tokens; a prompt bucket with no room for the fused steps falls back
    by itself (_use_fused)."""
    eng = batcher[0]
    monkeypatch.setenv("MIOTTS_FUSED_PREFILL", "0")
    b = _own(eng)
    try:
        assert not b.fused_prefill
        got = b.submit("hi", SamplerParams(temp=0.0), n_predict=20).collect()
    finally:
        b.shutdown()
    assert got == eng.generate_audio_tokens("hi", n_predict=20, n_ctx=64,
                                            sampler=SamplerParams(temp=0.0))
    monkeypatch.delenv("MIOTTS_FUSED_PREFILL")
    b2 = _own(eng, max_ctx=39)  # bucket 32 + first_chunk 8 > 39
    try:
        assert b2.fused_prefill and not b2._use_fused(32)
        got2 = b2.submit("hi", SamplerParams(temp=0.0), n_predict=4).collect()
    finally:
        b2.shutdown()
    assert got2 == eng.generate_audio_tokens("hi", n_predict=4, n_ctx=64,
                                             sampler=SamplerParams(temp=0.0))


def test_fused_prefill_early_eog_and_budget(batcher):
    """Requests that end inside the fused steps (n_predict 3 < first_chunk)
    complete with their tokens and free their lane, over and over."""
    eng, b, _ = batcher
    expect = eng.generate_audio_tokens("hello", n_predict=3, n_ctx=64,
                                       sampler=SamplerParams(temp=0.0))
    for _ in range(6):
        assert b.submit("hello", SamplerParams(temp=0.0), n_predict=3).collect() == expect
    assert all(lane is None for lane in b.lanes)


def test_binary_lane_skips_first_chunk(batcher, monkeypatch):
    """Both a binary lane (early_tokens=False) and a streaming one get
    their first first_chunk tokens from the fused prefill; the binary lane
    then votes chunk_max at once, the lone streaming lane skips the middle
    rung: chunks of 16, then the remaining 4, for both."""
    eng = batcher[0]
    b = _own(eng, first_chunk=4)
    try:
        assert b.first_chunk == 4 and b.ladder == (4, 8, 16)
        ran = _spy_runs(monkeypatch)
        got = b.submit("hi", SamplerParams(temp=0.0), n_predict=24, early_tokens=False).collect()
        binary_sizes, ran[:] = _worker_steps(b, ran), []
        got_early = b.submit("hi", SamplerParams(temp=0.0), n_predict=24).collect()
        early_sizes = _worker_steps(b, ran)
    finally:
        b.shutdown()
    expect = eng.generate_audio_tokens("hi", n_predict=24, n_ctx=64,
                                       sampler=SamplerParams(temp=0.0))
    assert got == expect and got_early == expect
    assert binary_sizes[0] != 4
    if len(expect) == 24:
        assert binary_sizes == [16, 4] and early_sizes == [16, 4]


def test_cold_group_sizes_split_to_warmed_during_warmup_tail(batcher, monkeypatch):
    """While the warm-up tail runs (split_cold_until_warm), a burst that
    would coalesce into a group size not yet warm splits into the largest
    warm one, and greedy results still equal the single-request path."""
    eng = batcher[0]
    b = _own(eng, n_lanes=4, max_ctx=128)
    try:
        b.warm_prefill(32)
        b.warm_prefill(32, n_lanes=2)
        assert {(32, 1), (32, 2)} <= set(b._warm_prefills)
        b.split_cold_until_warm = True
        ran = _spy_runs(monkeypatch)
        texts = ["a", "bb", "ccc", "dddd"]
        barrier = threading.Barrier(len(texts))

        def one(text):
            barrier.wait()
            return b.submit(text, SamplerParams(temp=0.0), n_predict=8).collect()

        with concurrent.futures.ThreadPoolExecutor(len(texts)) as ex:
            results = list(ex.map(one, texts))
        seen = [int(ch.state.pos.shape[0]) for ch in ran if ch.state is not b.state]
        assert seen and max(seen) <= 2 and set(b._fused) <= {1, 2}
        for text, got in zip(texts, results):
            assert got == eng.generate_audio_tokens(text, n_predict=8, n_ctx=64,
                                                    sampler=SamplerParams(temp=0.0)), text
    finally:
        b.shutdown()


def test_graph_per_rung_width_and_fused_match_eager(batcher, monkeypatch):
    """Slicing and the fused prefill on: the fused first chunk of k = 1
    lanes runs on its own state of max_ctx rows, then width-1 chunks of the
    live state run 16 and 4 steps, and the tokens equal the single-request
    path's."""
    eng = batcher[0]
    ran = _spy_runs(monkeypatch)
    b = _own(eng, first_chunk=4)
    try:
        got = b.submit("hi", SamplerParams(temp=0.0), n_predict=24, early_tokens=False).collect()
        runs = list(ran)
        fused = b._fused[1][0]
        assert fused.state.cache_k.shape[2] == b.max_ctx and not fused.captured
        assert set(b.chunks) <= {(16, 1), (4, 1)}
        assert all(ch.state is b.state for ch in b.chunks.values())
    finally:
        b.shutdown()
    expect = eng.generate_audio_tokens("hi", n_predict=24, n_ctx=64,
                                       sampler=SamplerParams(temp=0.0))
    assert got == expect
    if len(got) == 24:
        assert [ch.n_steps for ch in runs] == [4, 16, 4] and runs[0] is fused


def _slow_prefill(b, monkeypatch, delay):
    real = b._prefill_group

    def slow(bucket, group):
        time.sleep(delay)
        return real(bucket, group)

    monkeypatch.setattr(b, "_prefill_group", slow)


def test_attach_hold_waits_for_a_burst(batcher, monkeypatch):
    """One lane running and two reserved lanes still prefilling (a strict
    majority): the worker holds its dispatch (counted, in waits of at most
    50 ms) until they attach; every lane's greedy tokens stay the
    single-request path's."""
    eng = batcher[0]
    b = _own(eng, n_lanes=4)
    try:
        assert b.attach_hold_s == 1.0
        first = b.submit("hold a", SamplerParams(temp=0.0), n_predict=60)
        toks = first.tokens()
        head = [next(toks)]  # attached and running
        _slow_prefill(b, monkeypatch, 0.3)
        others = [b.submit(t, SamplerParams(temp=0.0), n_predict=20) for t in ("hold b", "hold c")]
        got = head + list(toks)
        rest = [h.collect() for h in others]
        assert b.attach_holds >= 1 and b.attach_hold_ms > 50
    finally:
        b.shutdown()
    assert got == eng.generate_audio_tokens("hold a", n_predict=60, n_ctx=64,
                                            sampler=SamplerParams(temp=0.0))
    for text, r in zip(("hold b", "hold c"), rest):
        assert r == eng.generate_audio_tokens(text, n_predict=20, n_ctx=64,
                                              sampler=SamplerParams(temp=0.0))


def test_attach_hold_skips_a_trickle_and_is_bounded(batcher, monkeypatch):
    """One new lane beside one running lane never holds (not a strict
    majority); with MIOTTS_ATTACH_HOLD_S=0.1 a hold ends after its cap
    while the burst's prefill still waits: the running lane runs to its
    end with the burst unattached, and only then is the prefill let go."""
    eng = batcher[0]
    b = _own(eng, n_lanes=4)
    try:
        first = b.submit("trickle a", SamplerParams(temp=0.0), n_predict=40)
        toks = first.tokens()
        next(toks)
        _slow_prefill(b, monkeypatch, 0.3)
        b.submit("trickle b", SamplerParams(temp=0.0), n_predict=8).collect()
        list(toks)
        assert b.attach_holds == 0
    finally:
        b.shutdown()
    monkeypatch.undo()  # the slow prefill above
    monkeypatch.setenv("MIOTTS_ATTACH_HOLD_S", "0.1")
    b = _own(eng, n_lanes=4)
    release = threading.Event()
    try:
        assert b.attach_hold_s == 0.1
        first = b.submit("bounded a", SamplerParams(temp=0.0), n_predict=60)
        toks = first.tokens()
        next(toks)
        real = b._prefill_group

        def gated(bucket, group):
            # a hold that never ends would keep the running lane from its
            # end, and so this prefill from its release: fail, not hang
            if not release.wait(30):
                raise AssertionError("the burst's prefill was not released in 30 s")
            return real(bucket, group)

        monkeypatch.setattr(b, "_prefill_group", gated)
        others = [b.submit(t, SamplerParams(temp=0.0), n_predict=4) for t in ("b", "c")]
        list(toks)  # runs on after the 0.1 s hold, while the burst's prefill waits
        with b._cv:
            burst = [lane for lane in b.lanes if lane is not None]
        assert len(burst) == 2 and not any(lane.started for lane in burst)
        release.set()
        for h in others:
            h.collect()
        assert b.attach_holds >= 1 and b.attach_hold_ms < 300
    finally:
        release.set()
        b.shutdown()


def test_chunk_depth_two_dispatches_ahead(batcher, monkeypatch):
    """MIOTTS_CHUNK_DEPTH=2: chunks are dispatched ahead of their reads
    (up to three queued), and greedy lanes of mixed budgets, attached and
    freed while chunks are in flight, keep the single-request tokens."""
    eng = batcher[0]
    monkeypatch.setenv("MIOTTS_CHUNK_DEPTH", "2")
    counts = {"out": 0, "max": 0}
    real_start, real_finish = bmod.start_chunk_fetch, bmod.finish_chunk_fetch

    def start(*a):
        counts["out"] += 1
        counts["max"] = max(counts["max"], counts["out"])
        return real_start(*a)

    def finish(f):
        counts["out"] -= 1
        return real_finish(f)

    monkeypatch.setattr(bmod, "start_chunk_fetch", start)
    monkeypatch.setattr(bmod, "finish_chunk_fetch", finish)
    b = _own(eng, n_lanes=2)
    try:
        assert b.depth == 2
        texts = [("depth a", 50), ("depth b", 13), ("depth c", 30), ("depth d", 21)]
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            got = list(ex.map(lambda tn: b.submit(tn[0], SamplerParams(temp=0.0),
                                                  n_predict=tn[1]).collect(), texts))
    finally:
        b.shutdown()
    assert counts["max"] >= 3
    for (text, n), g in zip(texts, got):
        assert g == eng.generate_audio_tokens(text, n_predict=n, n_ctx=64,
                                              sampler=SamplerParams(temp=0.0)), text


def test_delivery_skips_a_lane_attached_again(batcher):
    """A chunk in flight whose lane was freed and taken by a new request
    delivers nothing to the new request (the snapshot holds lane objects)."""
    b = batcher[1]
    old = bmod._Lane(handle=bmod.GenerationHandle(), n_predict=10, started=True)
    new = bmod._Lane(handle=bmod.GenerationHandle(), n_predict=10, started=True)
    with b._cv:
        b.lanes[3] = new
    try:
        out = np.full((b.n_lanes, 4), 7, np.int32)
        b._deliver_chunk(out, np.full(b.n_lanes, 4, np.int32), np.zeros(b.n_lanes, bool),
                         [(3, old)])
        assert new.generated == 0 and new.handle._q.empty() and old.handle._q.empty()
        b._deliver_chunk(out, np.full(b.n_lanes, 4, np.int32), np.zeros(b.n_lanes, bool),
                         [(3, new)])
        assert new.generated == 4 and new.handle._q.get_nowait() == [7, 7, 7, 7]
    finally:
        with b._cv:
            b.lanes[3] = None


def test_fused_graph_runs_unbudgeted(batcher, monkeypatch):
    """The fused first chunk runs its steps with no budget, as JAX's (rem
    None): its body reads a ``rem`` buffer of NO_BUDGET that only the chunk
    holds, through the body it keeps (the body the card captures)."""
    eng = batcher[0]
    ran = _spy_runs(monkeypatch)
    b = _own(eng, first_chunk=4)
    try:
        b.submit("hi", SamplerParams(temp=0.0), n_predict=6).collect()
        fused = b._fused[1][0]
        assert ran[0] is fused
        rems = [c.cell_contents for c in fused.body.__closure__
                if torch.is_tensor(c.cell_contents) and c.cell_contents.dtype == torch.int32]
        assert rems and all(int(r.min()) == llm_mod.NO_BUDGET for r in rems)
    finally:
        b.shutdown()
