"""The port's continuous batching against the JAX package: the per-lane
sampler (``sample_token_batched``), the batched chunk API (``attach_lanes``,
``set_lane_done``, the chunk with ``rem``) and the ``ContinuousBatcher``
(miotts_tpu_torch/serving/batching.py) on a tiny f32 GGUF.

Greedy lanes give JAX's tokens exactly. A sampled lane's tokens depend only
on its seed, never on its neighbours: its key is its own and its uniforms
are indexed within its row. On the CPU a chunk runs the eager body; a
stand-in chunk graph drives the CUDA path's choice of graph per dispatch."""

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
    every chunk."""
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
        out, n_new, _ = llm_mod.llm_generate_chunk_batched(
            cfg, w, torch.tensor(eog), steps, sampler, state, torch.from_numpy(rem))
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
        real = bmod.llm_generate_chunk_batched
        calls = {"n": 0}

        def boom(*a, **k):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected device failure")
            return real(*a, **k)

        monkeypatch.setattr(bmod, "llm_generate_chunk_batched", boom)
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


def test_worker_survives_attach_failure(batcher, monkeypatch):
    """A failed attach fails only that group; the worker keeps serving."""
    eng = batcher[0]
    b = _own(eng)
    try:
        real = bmod.attach_lanes
        calls = {"n": 0}

        def boom(state, *args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected attach failure")
            return real(state, *args, **kwargs)

        monkeypatch.setattr(bmod, "attach_lanes", boom)
        with pytest.raises(RuntimeError, match="injected attach failure"):
            b.submit("fail in attach", n_predict=8).collect()
        assert len(b.submit("works again", n_predict=8).collect()) > 0
    finally:
        b.shutdown()


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


class _EagerGraph(decode_graph.ChunkGraph):
    """A chunk graph without CUDA: it keeps the state and runs the body on
    it where a replay would. Records the sizes made and replayed."""

    def __init__(self, body, state, n_steps):
        self.state, self.body, self.n_steps = state, body, n_steps
        self.out = torch.zeros((state.pos.shape[0], n_steps), dtype=torch.int64)
        self.n_new = torch.zeros((state.pos.shape[0],), dtype=torch.int32)
        _EagerGraph.made.append(n_steps)

    def run(self):
        _EagerGraph.replayed.append(self.n_steps)
        self.body(self.state, self.out, self.n_new)
        return self.out, self.n_new


@pytest.mark.parametrize("early,first_chunk,expect", [
    # a streaming lane: the TTFA-first chunk, then (solo, uncontended)
    # chunk_max, and the last budget-shrunk dispatch runs the rung above it
    (True, 4, [4, 16, 4]),
    # a binary lane votes chunk_max outright; the remaining 8 runs rung 8
    (False, 4, [16, 8]),
])
def test_graph_per_rung_matches_eager(batcher, monkeypatch, early, first_chunk, expect):
    """The CUDA path on stand-in graphs: one graph per ladder size over one
    shared state, each dispatch replays the smallest rung at or above its
    size, and the tokens equal the eager batcher's."""
    eng = batcher[0]
    monkeypatch.setattr(decode_graph, "ChunkGraph", _EagerGraph)
    _EagerGraph.made, _EagerGraph.replayed = [], []
    b = _own(eng, first_chunk=first_chunk)
    b.use_graph = True
    try:
        assert b.ladder == (first_chunk, 8, 16)
        b.warm_chunks()
        assert _EagerGraph.made == [first_chunk, 8, 16]
        assert all(g.state is b.state for g in b.graphs.values())
        got = b.submit("hi", SamplerParams(temp=0.0), n_predict=24, early_tokens=early).collect()
    finally:
        b.shutdown()
    assert got == eng.generate_audio_tokens("hi", n_predict=24, n_ctx=64,
                                            sampler=SamplerParams(temp=0.0))
    if len(got) == 24:  # no early EOG: the walk is fixed
        assert _EagerGraph.replayed == expect


def test_contended_lanes_keep_middle_rung(batcher, monkeypatch):
    """Two streaming requests in flight: the middle rung (8) stays in use."""
    eng = batcher[0]
    sizes = []
    real = bmod.llm_generate_chunk_batched

    def spy(cfg, w, eog, steps, sampler, state, rem):
        sizes.append(steps)
        return real(cfg, w, eog, steps, sampler, state, rem)

    monkeypatch.setattr(bmod, "llm_generate_chunk_batched", spy)
    b = _own(eng)
    try:
        h1 = b.submit("hi", SamplerParams(temp=0.0), n_predict=40)
        h2 = b.submit("hi there", SamplerParams(temp=0.0), n_predict=40)
        got1, got2 = h1.collect(), h2.collect()
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
