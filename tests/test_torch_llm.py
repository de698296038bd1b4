"""The port's LLM and sampler against the JAX package on a tiny GGUF
(2 layers, dim 32, GQA 4/2).

f32 weights on both sides: prefill logits agree to atol 1e-4 and 16 greedy
tokens are identical. bf16 weights: both loaders round the norm weights to
bf16 before widening them to f32, and the heads sum into f32. What is left
is ``silu``: XLA:CPU computes JAX's bf16 ``silu`` as exp, add, divide and
multiply, each rounded to bf16, where the port rounds ``F.silu`` once (as a
silu fused and computed in f32 does). With that expansion patched into the
port the logits agree to 1e-5; with the port's own silu to 0.05. Token
identity is not required at bf16. The RNGs differ, so sampling is held to
the softmax by distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.models import llm as jllm
from miotts_tpu.models import sampling as jsampling
from miotts_tpu_torch.convert import llm_params_from_jax
from miotts_tpu_torch.models import decode_graph, llm as llm_mod
from miotts_tpu_torch.models.llm import (
    LLMEngine, _logits, init_kv_cache, llm_decode_step, llm_prefill, llm_prefill_kv,
    load_llm_gguf)
from miotts_tpu_torch.models.sampling import (
    SamplerParams, SamplerState, sample_token, sampler_key, uniform)
from miotts_tpu_torch.ops.cuda import llm_gemv
from miotts_tpu_torch.testing import write_synthetic_llm_gguf

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny_llm(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("llm") / "tiny_llm.gguf")
    write_synthetic_llm_gguf(path, n_audio=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                             ffn=64, seed=0)
    return path


def _prompts():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 300, (2, 12)).astype(np.int32)
    return toks, np.array([12, 7], np.int32)


def _jax_prefill(path, dtype):
    cfg, w, _ = jllm.load_llm_gguf(path, dtype=dtype)
    toks, lens = _prompts()
    last, _, _ = jllm.llm_prefill_kv(cfg, w, jnp.asarray(toks), jnp.asarray(lens))
    return cfg, w, np.asarray(last, np.float32)


@pytest.mark.parametrize("source,layout", [
    ("gguf", "token"), ("jax_tree", "token"), ("jax_tree", "feature")])
def test_prefill_logits_f32(tiny_llm, source, layout, monkeypatch):
    # the JAX loader keeps its logits head [V, D] or [D, V] by this switch
    monkeypatch.setenv("MIOTTS_OUTPUT_LAYOUT", layout)
    jcfg, jw, ref = _jax_prefill(tiny_llm, jnp.float32)
    assert jcfg.output_token_major == (layout == "token")
    if source == "gguf":
        cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.float32)
    else:
        cfg, w = llm_params_from_jax(jcfg, jax.tree.map(np.asarray, jw), CPU, torch.float32)
    toks, lens = _prompts()
    last, k, v = llm_prefill_kv(cfg, w, torch.from_numpy(toks), torch.from_numpy(lens))
    assert k.shape == (2, 2, 12, 2, 8) and v.shape == k.shape
    np.testing.assert_allclose(last.numpy(), ref, atol=1e-4, rtol=0)


def test_prefill_logits_bf16(tiny_llm):
    """At bf16 each package is ~0.05 from the f32 logits (|x| <= 3.4 here).
    The two heads agree to 1e-5 on the same hidden state; the rest (0.031
    measured) is silu's rounding (test_prefill_logits_bf16_xla_silu), hence
    atol 0.05. The port's distance from f32 stays within twice JAX's own."""
    jcfg, jw, ref = _jax_prefill(tiny_llm, jnp.bfloat16)
    _, _, ref32 = _jax_prefill(tiny_llm, jnp.float32)
    cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.bfloat16)
    toks, lens = _prompts()
    last, _, _ = llm_prefill_kv(cfg, w, torch.from_numpy(toks), torch.from_numpy(lens))
    assert last.dtype == torch.float32
    np.testing.assert_allclose(last.numpy(), ref, atol=0.05, rtol=0)
    assert np.abs(last.numpy() - ref32).max() <= 2 * np.abs(ref - ref32).max()
    xn = np.random.RandomState(4).randn(2, cfg.dim).astype(np.float32)
    head = np.asarray(jllm._logits_matmul(jcfg, jw, jnp.asarray(xn, jnp.bfloat16)))
    got = _logits(cfg, w, torch.from_numpy(xn).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), head, atol=1e-5, rtol=0)


def _xla_cpu_silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu on bf16 as XLA:CPU computes it: x * 1 / (1 + exp(-x)),
    the exp, the add, the divide and the multiply each rounded to bf16."""
    bf = torch.bfloat16
    e = torch.exp(-x.float()).to(bf)
    d = (1 + e.float()).to(bf)
    return (x.float() * (1 / d.float()).to(bf).float()).to(bf)


def test_prefill_logits_bf16_xla_silu(tiny_llm, monkeypatch):
    """The bf16 logits gap is the reference backend's rounding, not a fault
    of the port: with XLA:CPU's silu patched in (bit-equal to jax.nn.silu
    here) and the norms loaded as JAX loads them, the port's bf16 prefill
    logits equal JAX's to the f32 head tolerance."""
    x = np.random.RandomState(5).randn(4096).astype(np.float32) * 4
    want = np.asarray(jax.nn.silu(jnp.asarray(x, jnp.bfloat16)), np.float32)
    np.testing.assert_array_equal(_xla_cpu_silu(torch.from_numpy(x).to(torch.bfloat16)).float().numpy(),
                                  want)
    jcfg, jw, ref = _jax_prefill(tiny_llm, jnp.bfloat16)
    cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.bfloat16)
    for k in ("attn_norm", "ffn_norm", "output_norm"):
        assert w[k].dtype == torch.float32
        np.testing.assert_array_equal(w[k].numpy(), np.asarray(jw[k], np.float32))
    monkeypatch.setattr(llm_mod.F, "silu", _xla_cpu_silu)
    toks, lens = _prompts()
    last, _, _ = llm_prefill_kv(cfg, w, torch.from_numpy(toks), torch.from_numpy(lens))
    np.testing.assert_allclose(last.numpy(), ref, atol=1e-5, rtol=0)


def test_decode_step_matches_jax(tiny_llm):
    """Prefill into a bf16 cache, then three decode steps with ragged pos:
    logits match JAX's (f32 weights) and the cache rows written match."""
    jcfg, jw, _ = jllm.load_llm_gguf(tiny_llm, dtype=jnp.float32)
    cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.float32)
    toks, lens = _prompts()
    jck, jcv = jllm.init_kv_cache(jcfg, 2, 24)
    jlog, jck, jcv = jllm.llm_prefill(jcfg, jw, jnp.asarray(toks), jnp.asarray(lens), jck, jcv)
    ck, cv = init_kv_cache(cfg, 2, 24, CPU)
    llm_prefill(cfg, w, torch.from_numpy(toks), torch.from_numpy(lens), ck, cv)
    pos = lens.copy()
    for step in range(3):
        tok = np.array([5 + step, 70 + step], np.int32)
        jlog, jck, jcv = jllm.llm_decode_step(jcfg, jw, jnp.asarray(tok), jnp.asarray(pos),
                                              jck, jcv)
        log = llm_decode_step(cfg, w, torch.from_numpy(tok), torch.from_numpy(pos), ck, cv)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4, rtol=0)
        pos += 1
    for b, p in enumerate(pos):
        np.testing.assert_allclose(ck[:, b, :p].float().numpy(),
                                   np.asarray(jck[:, b, :p], np.float32), atol=2e-2, rtol=0)


def test_decode_step_at_cache_end(tiny_llm):
    """pos = S-1 writes the last cache row; pos >= S writes nothing (JAX's
    mode="drop" scatter), and both lanes' logits still match."""
    jcfg, jw, _ = jllm.load_llm_gguf(tiny_llm, dtype=jnp.float32)
    cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.float32)
    S = 12
    rng = np.random.RandomState(2)
    jck, jcv = (jnp.asarray(rng.randn(2, 2, S, 2, 8), jnp.bfloat16) for _ in range(2))
    ck, cv = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in (jck, jcv))
    tok, pos = np.array([3, 4], np.int32), np.array([S - 1, S], np.int32)
    jlog, jck, jcv = jllm.llm_decode_step(jcfg, jw, jnp.asarray(tok), jnp.asarray(pos), jck, jcv)
    log = llm_decode_step(cfg, w, torch.from_numpy(tok), torch.from_numpy(pos), ck, cv)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4, rtol=0)
    for got, ref in ((ck, jck), (cv, jcv)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_array_equal(got[:, 1].float().numpy(), ref[:, 1])  # dropped
        np.testing.assert_array_equal(got[:, 0, :S - 1].float().numpy(), ref[:, 0, :S - 1])
        np.testing.assert_allclose(got[:, 0, S - 1].float().numpy(), ref[:, 0, S - 1],
                                   atol=2e-2, rtol=0)


# The K11 route (``_decode_step_gemv``, taken on one card for dense bf16
# fused leaves) against JAX's step, bf16 on both sides. On the CPU its
# wrappers run their plain versions, which the card holds the kernels to.
# With XLA:CPU's silu patched in, the logits agree to the f32 head's
# tolerance and every cache row is equal; with the port's own silu, to the
# bf16 tolerances above.
GEMV_CONFIGS = {
    # qwen2: NEOX pairs, q|k|v bias, a dense head
    "qwen2": dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn=64, seed=0),
    # head_dim 64, the shapes the kernels take
    "hd64": dict(dim=128, n_layers=2, n_heads=2, n_kv_heads=1, ffn=128, seed=5),
    # llama: adjacent pairs, the head tied to the embedding
    "llama_tied": dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn=64, seed=4,
                       arch="llama", tied=True),
}
GEMV_CASES = [("qwen2", ""), ("hd64", ""), ("llama_tied", ""), ("qwen2", "output"),
              ("hd64", "output")]


@pytest.fixture(scope="module")
def gemv_llms(tmp_path_factory):
    root = tmp_path_factory.mktemp("gemv_llms")
    paths = {}
    for name, kw in GEMV_CONFIGS.items():
        paths[name] = str(root / f"{name}.gguf")
        write_synthetic_llm_gguf(paths[name], n_audio=64, **kw)
    return paths


def _gemv_pair(gemv_llms, name, quant):
    jcfg, jw, _ = jllm.load_llm_gguf(gemv_llms[name], dtype=jnp.bfloat16, quantize=quant)
    cfg, w, _ = load_llm_gguf(gemv_llms[name], CPU, torch.bfloat16, quantize=quant)
    assert w["wqkv"].dtype == torch.bfloat16 and w["w_gateup"] is not None
    assert isinstance(w["output"], dict) == (quant == "output")
    assert cfg.tie_embeddings == (w["output"] is None) == (name == "llama_tied")
    assert cfg.rope_neox == (name != "llama_tied")
    if cfg.head_dim == llm_gemv.HEAD_DIM:  # the card would take this route
        assert llm_mod.gemv_route(cfg, w, 2, "cuda")
    return jcfg, jw, cfg, w


def _to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("xla_silu", [True, False], ids=["xla_silu", "port_silu"])
@pytest.mark.parametrize("name,quant", GEMV_CASES)
def test_gemv_decode_step_matches_jax(gemv_llms, name, quant, xla_silu, monkeypatch):
    """JAX prefills a bf16 cache; from the same cache, three decode steps
    with ragged pos by JAX's step and by the K11 route."""
    jcfg, jw, cfg, w = _gemv_pair(gemv_llms, name, quant)
    if xla_silu:
        monkeypatch.setattr(llm_mod.F, "silu", _xla_cpu_silu)
    toks, lens = _prompts()
    jck, jcv = jllm.init_kv_cache(jcfg, 2, 24)
    _, jck, jcv = jllm.llm_prefill(jcfg, jw, jnp.asarray(toks), jnp.asarray(lens), jck, jcv)
    ck, cv = _to_torch(jck), _to_torch(jcv)
    pos = lens.copy()
    for step in range(3):
        tok = np.array([5 + step, 70 + step], np.int32)
        jlog, jck, jcv = jllm.llm_decode_step(jcfg, jw, jnp.asarray(tok), jnp.asarray(pos),
                                              jck, jcv)
        log = llm_mod._decode_step_gemv(cfg, w, torch.from_numpy(tok), torch.from_numpy(pos),
                                        ck, cv)
        assert log.dtype == torch.float32
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   atol=1e-5 if xla_silu else 0.05, rtol=0)
        pos += 1
    for got, ref in ((ck, jck), (cv, jcv)):
        ref = np.asarray(ref, np.float32)
        if xla_silu:
            np.testing.assert_array_equal(got.float().numpy(), ref)
        else:
            np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2, rtol=0)


@pytest.mark.parametrize("name,quant", GEMV_CASES)
def test_gemv_decode_step_at_cache_end(gemv_llms, name, quant, monkeypatch):
    """The K11 route at pos = S-1 (the last row written) and pos = S
    (nothing written, JAX's mode="drop"), from the same random cache."""
    jcfg, jw, cfg, w = _gemv_pair(gemv_llms, name, quant)
    monkeypatch.setattr(llm_mod.F, "silu", _xla_cpu_silu)
    S = 12
    rng = np.random.RandomState(2)
    shape = (cfg.n_layers, 2, S, cfg.n_kv_heads, cfg.head_dim)
    jck, jcv = (jnp.asarray(rng.randn(*shape), jnp.bfloat16) for _ in range(2))
    ck, cv = _to_torch(jck), _to_torch(jcv)
    before = ck.clone(), cv.clone()
    tok, pos = np.array([3, 4], np.int32), np.array([S - 1, S], np.int32)
    jlog, jck, jcv = jllm.llm_decode_step(jcfg, jw, jnp.asarray(tok), jnp.asarray(pos), jck, jcv)
    log = llm_mod._decode_step_gemv(cfg, w, torch.from_numpy(tok), torch.from_numpy(pos), ck, cv)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-5, rtol=0)
    for got, ref, old in ((ck, jck, before[0]), (cv, jcv, before[1])):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
        assert torch.equal(got[:, 1], old[:, 1])  # dropped
        assert torch.equal(got[:, 0, :S - 1], old[:, 0, :S - 1])


def test_greedy_tokens_match_jax_f32(tiny_llm):
    jeng = jllm.LLMEngine(tiny_llm, dtype=jnp.float32)
    eng = LLMEngine(tiny_llm, CPU, dtype=torch.float32)
    for text in ("hello there", "a longer prompt, with punctuation!"):
        ref = jeng.generate_audio_tokens(text, n_predict=16,
                                         sampler=jsampling.SamplerParams(temp=0.0))
        got = eng.generate_audio_tokens(text, n_predict=16, sampler=SamplerParams(temp=0.0))
        assert got == ref
    assert eng.tokens_to_codes(got) == jeng.tokens_to_codes(ref)
    assert sorted(eng.eog_ids.tolist()) == sorted(np.asarray(jeng.eog_ids).tolist())


@pytest.mark.parametrize("params", [
    dict(temp=0.0, top_k=5, top_p=1.0, repeat_penalty=1.3),
    dict(temp=0.0, top_k=0, top_p=0.5, repeat_penalty=1.0),
    dict(temp=0.0, top_k=3, top_p=0.9, repeat_penalty=0.7),
])
def test_greedy_sampler_chain_matches_jax(params):
    """Deterministic (greedy) chains: penalty, top-k and top-p select the
    same tokens as the JAX chain."""
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 50).astype(np.float32) * 2
    ring = np.full((3, 64), -1, np.int32)
    ring[:, :4] = rng.randint(0, 50, (3, 4))
    jstate = jsampling.SamplerState(ring=jnp.asarray(ring), idx=jnp.int32(4))
    ref = jsampling.sample_token(jnp.asarray(logits), jsampling.SamplerParams(**params),
                                 jstate, jax.random.PRNGKey(0))
    state = SamplerState(torch.from_numpy(ring).long(), torch.tensor(4, dtype=torch.int32))
    got = sample_token(torch.from_numpy(logits), SamplerParams(**params), state,
                       sampler_key(0, CPU))
    assert got.tolist() == np.asarray(ref).tolist()


def test_sampler_distribution_matches_softmax():
    """Distributional conformance (the port's counterpart of
    test_sampler_distribution_matches_softmax)."""
    logits = torch.tensor([[0.0, 1.0, 2.0]]).repeat(4000, 1)
    toks = sample_token(logits, SamplerParams(temp=1.0, top_k=0, top_p=1.0),
                        SamplerState.init(4000, CPU), sampler_key(0, CPU))
    counts = np.bincount(toks.numpy(), minlength=3) / 4000
    expect = np.exp([0, 1, 2]) / np.exp([0, 1, 2]).sum()
    np.testing.assert_allclose(counts, expect, atol=0.03)


def test_sampler_state_ring():
    state = SamplerState.init(2, CPU)
    for i in range(70):
        state.update(torch.tensor([i, 100 + i]))
    assert state.idx.dtype == torch.int32 and int(state.idx) == 70
    assert sorted(state.ring[0].tolist()) == list(range(6, 70))


def test_sampler_ring_matches_jax():
    """70 updates (the 64-slot ring wraps): the device ring and its int32
    cursor equal JAX's update_sampler_state."""
    rng = np.random.RandomState(6)
    toks = rng.randint(0, 1000, (70, 3))
    jstate = jsampling.init_sampler_state(3)
    state = SamplerState.init(3, CPU)
    for t in toks:
        jstate = jsampling.update_sampler_state(jstate, jnp.asarray(t, jnp.int32))
        state.update(torch.from_numpy(t))
    assert int(state.idx) == int(jstate.idx) == 70
    np.testing.assert_array_equal(state.ring.numpy(), np.asarray(jstate.ring))


def _f32_pair(path):
    jcfg, jw, _ = jllm.load_llm_gguf(path, dtype=jnp.float32)
    cfg, w, _ = load_llm_gguf(path, CPU, torch.float32)
    return jcfg, jw, cfg, w


def _lanes(B):
    toks, lens = _prompts()
    return toks[:B], lens[:B]


def _eog_inside_chunk(jcfg, jw, toks, lens):
    """An EOG set that stops lane 0 at its 8th greedy token (inside the
    second chunk of 5): that token, from a probe run with no EOG."""
    B = toks.shape[0]
    jck, jcv = jllm.init_kv_cache(jcfg, B, 48)
    out, _ = jllm.llm_generate(jcfg, jw, jnp.asarray(toks), jnp.asarray(lens),
                               jnp.asarray([-1], jnp.int32), jax.random.PRNGKey(0), 16,
                               jsampling.SamplerParams(temp=0.0), jck, jcv)
    return [int(np.asarray(out)[0, 7])]


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("stop", [False, True])
def test_chunk_api_matches_jax(tiny_llm, B, stop):
    """llm_start + runs of one chunk of 5 steps (``llm.chunk``) up to 16
    tokens, f32 greedy, one lane and a ragged pair (prompt lengths 12 and
    7); with ``stop`` lane 0 meets an EOG inside a chunk. Tokens, n_new,
    pos and done equal JAX's after every chunk."""
    jcfg, jw, cfg, w = _f32_pair(tiny_llm)
    toks, lens = _lanes(B)
    eog = _eog_inside_chunk(jcfg, jw, toks, lens) if stop else [-1]
    greedy_j, greedy = jsampling.SamplerParams(temp=0.0), SamplerParams(temp=0.0)
    jck, jcv = jllm.init_kv_cache(jcfg, B, 48)
    jstate = jllm.llm_start(jcfg, jw, jnp.asarray(toks), jnp.asarray(lens), jck, jcv,
                            jax.random.PRNGKey(0))
    ck, cv = init_kv_cache(cfg, B, 48, CPU)
    state = llm_mod.llm_start(cfg, w, torch.from_numpy(toks), torch.from_numpy(lens), ck, cv,
                              sampler_key(0, CPU))
    ch = llm_mod.chunk(cfg, w, torch.tensor(eog, dtype=torch.int64), 5, greedy, state)
    assert ch.state is state and not ch.captured
    got_tokens, total = 0, np.zeros(B, np.int64)
    while got_tokens < 16:
        jout, jn, jstate = jllm.llm_generate_chunk(jcfg, jw, jnp.asarray(eog, jnp.int32), 5,
                                                   greedy_j, jstate)
        jo, jn_np, jdone = jllm.fetch_chunk_result(jout, jn, jstate)
        out, n_new = ch.run()
        o, n_np, done = llm_mod.fetch_chunk_result(out, n_new, state)
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(n_np, jn_np)
        np.testing.assert_array_equal(done, jdone)
        np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
        got_tokens += 5
        total += n_np
    assert bool(done[0]) == stop
    if stop:  # stopped inside the second chunk; the EOG step does not advance pos
        assert 5 < total[0] <= 8 and state.pos[0] == lens[0] + total[0] - 1


def test_chunk_graph_needs_cuda(tiny_llm):
    """The graph path is CUDA only: on the CPU ``llm.chunk`` makes a chunk
    that is not captured (read-only), and a capture asked of
    ``decode_graph.Chunk`` there raises."""
    cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.float32)
    state = llm_mod.empty_gen_state(cfg, 1, 32, CPU)
    ch = llm_mod.chunk(cfg, w, torch.tensor([-1]), 4, SamplerParams(temp=0.0), state)
    assert not ch.captured and ch.state is state
    with pytest.raises(AttributeError):
        ch.captured = True
    with pytest.raises(ValueError, match="CUDA"):
        decode_graph.Chunk(ch.body, state, 4, capture=True)


_SAMPLED = SamplerParams(temp=1.0, top_k=0)


def test_chunk_graph_serves_successive_requests(tiny_llm):
    """One chunk serves request after request: each is loaded into the
    chunk's buffers and gives the tokens of a run on a chunk of its own
    (fresh cache), whatever ran in the kept chunk before it. Sampled, seeds
    1, 1, 2, 1 over two prompts."""
    cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.float32)
    toks, lens = _prompts()
    eog = torch.tensor([-1])
    kept = llm_mod.chunk(cfg, w, eog, llm_mod.CHUNK, _SAMPLED,
                         llm_mod.empty_gen_state(cfg, 1, 64, CPU))
    runs = []
    for seed, lane in ((1, 0), (1, 0), (2, 0), (1, 1)):
        args = (cfg, w, torch.from_numpy(toks[lane:lane + 1]),
                torch.from_numpy(lens[lane:lane + 1]), eog, sampler_key(seed, CPU), 40, _SAMPLED)
        ref, n_ref = llm_mod.llm_generate(*args, *init_kv_cache(cfg, 1, 64, CPU))
        got, n = llm_mod.llm_generate(*args, kept.state.cache_k, kept.state.cache_v, kept)
        assert torch.equal(got, ref) and torch.equal(n, n_ref)
        runs.append(got)
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], runs[3])


def test_engine_keeps_one_chunk_graph(tiny_llm, monkeypatch):
    """The engine generates through the one chunk it keeps (plain and
    streaming) with the tokens of engines that each make their own for one
    request, reuses it while the cache rows and the sampler (seed aside)
    stay, and makes a new one when either changes."""
    cases = [(700, SamplerParams(temp=1.0, top_k=0, seed=s)) for s in (1, 2, 1)]
    cases += [(700, SamplerParams(temp=0.0)), (720, SamplerParams(temp=0.0))]

    def fresh():
        return LLMEngine(tiny_llm, CPU, dtype=torch.float32)

    ref = [(fresh().generate_audio_tokens("hello there", n_predict=24, n_ctx=n, sampler=s),
            fresh().generate_audio_tokens_streaming("hello there", None, n_predict=24, n_ctx=n,
                                                    sampler=s))
           for n, s in cases]
    eng = fresh()
    made = []
    real = llm_mod.chunk
    monkeypatch.setattr(llm_mod, "chunk", lambda *a, **k: made.append(real(*a, **k)) or made[-1])
    got = [(eng.generate_audio_tokens("hello there", n_predict=24, n_ctx=n, sampler=s),
            eng.generate_audio_tokens_streaming("hello there", None, n_predict=24, n_ctx=n,
                                                sampler=s))
           for n, s in cases]
    assert got == ref
    assert len(made) == 3 and eng._chunk is made[-1]
    assert ref[0] != ref[1] and ref[0] == ref[2]


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("stop", [False, True])
def test_llm_generate_matches_jax(tiny_llm, B, stop):
    """llm_generate over chunks of 16 gives JAX's while-loop tokens and
    counts, for 21 tokens (a whole chunk and a truncated one), with and
    without a lane stopping early."""
    jcfg, jw, cfg, w = _f32_pair(tiny_llm)
    toks, lens = _lanes(B)
    eog = _eog_inside_chunk(jcfg, jw, toks, lens) if stop else [-1]
    jck, jcv = jllm.init_kv_cache(jcfg, B, 64)
    jout, jn = jllm.llm_generate(jcfg, jw, jnp.asarray(toks), jnp.asarray(lens),
                                 jnp.asarray(eog, jnp.int32), jax.random.PRNGKey(0), 21,
                                 jsampling.SamplerParams(temp=0.0), jck, jcv)
    ck, cv = init_kv_cache(cfg, B, 64, CPU)
    out, n = llm_mod.llm_generate(cfg, w, torch.from_numpy(toks), torch.from_numpy(lens),
                                  torch.tensor(eog), sampler_key(0, CPU), 21,
                                  SamplerParams(temp=0.0), ck, cv)
    assert out.shape == (B, 21)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert (int(n[0]) <= 8) == stop


@pytest.mark.parametrize("text,n_predict", [("hello there", 16), ("a longer prompt, with punctuation!", 37)])
def test_streaming_tokens_match(tiny_llm, text, n_predict):
    """generate_audio_tokens_streaming (chunks of 16, truncated on the host)
    gives the same tokens as generate_audio_tokens and as JAX's streaming
    method, f32 greedy; on_token sees every token in order."""
    jeng = jllm.LLMEngine(tiny_llm, dtype=jnp.float32)
    eng = LLMEngine(tiny_llm, CPU, dtype=torch.float32)
    seen = []
    got = eng.generate_audio_tokens_streaming(
        text, lambda t, i, e: seen.append((t, i, e)) or True, n_predict=n_predict,
        sampler=SamplerParams(temp=0.0))
    ref = jeng.generate_audio_tokens_streaming(text, None, n_predict=n_predict,
                                               sampler=jsampling.SamplerParams(temp=0.0))
    assert got == ref
    assert got == eng.generate_audio_tokens(text, n_predict=n_predict,
                                            sampler=SamplerParams(temp=0.0))
    assert [t for t, _, _ in seen] == got and [i for _, i, _ in seen] == list(range(len(got)))
    eog = set(eng.eog_ids.tolist())
    assert [e for _, _, e in seen] == [t in eog for t in got]
    assert all(eng.token_to_code_or_none(t) == eng.token_to_code.get(t) for t in got)


def test_streaming_on_token_cancels(tiny_llm):
    """on_token returning False stops generation at that token."""
    eng = LLMEngine(tiny_llm, CPU, dtype=torch.float32)
    full = eng.generate_audio_tokens_streaming("hello there", None, n_predict=40,
                                               sampler=SamplerParams(temp=0.0))
    got = eng.generate_audio_tokens_streaming("hello there", lambda t, i, e: i < 20,
                                              n_predict=40, sampler=SamplerParams(temp=0.0))
    assert len(full) > 21 and got == full[:21]


def test_sampled_generation_is_seeded(tiny_llm):
    """The Gumbel-max draw follows its key: one seed gives one token
    sequence twice, another seed another."""
    eng = LLMEngine(tiny_llm, CPU, dtype=torch.float32)
    runs = [eng.generate_audio_tokens("hello there", n_predict=24,
                                      sampler=SamplerParams(temp=1.0, top_k=0, seed=s))
            for s in (1, 1, 2)]
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_uniform_draws():
    """The counter-based uniforms: in (0, 1), a function of (seed, draw,
    element) only, and spread evenly (each decile within 1% of 10% over
    100 000 draws; the mean of a uniform within 0.005 of 1/2)."""
    key = sampler_key(3, CPU)
    u = uniform(key, (100, 1000))
    assert u.dtype == torch.float32 and float(u.min()) > 0 and float(u.max()) < 1
    assert torch.equal(u, uniform(sampler_key(3, CPU), (100, 1000)))
    key2 = key.clone()
    key2[1] += 1
    for other in (uniform(key2, (100, 1000)), uniform(sampler_key(4, CPU), (100, 1000))):
        assert float((other == u).float().mean()) < 1e-3
    deciles = np.bincount((u.numpy().ravel() * 10).astype(int), minlength=10) / u.numel()
    np.testing.assert_allclose(deciles, 0.1, atol=0.01)
    assert abs(float(u.mean()) - 0.5) < 5e-3
    assert int(key[1]) == 0  # a draw leaves the key as it is
