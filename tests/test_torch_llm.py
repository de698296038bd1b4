"""The port's LLM and sampler against the JAX package on a tiny GGUF
(2 layers, dim 32, GQA 4/2).

f32 weights on both sides: prefill logits agree to atol 1e-4 and 16 greedy
tokens are identical. bf16 weights: logits agree to atol 0.12 (the head
sums into f32 on both sides; bf16 activations differ by an ulp here and
there inside the layers); token identity is not required. The RNGs differ,
so sampling is held to the softmax by distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.models import llm as jllm
from miotts_tpu.models import sampling as jsampling
from miotts_tpu_torch.convert import llm_params_from_jax
from miotts_tpu_torch.models.llm import (
    LLMEngine, _logits, init_kv_cache, llm_decode_step, llm_prefill, llm_prefill_kv,
    load_llm_gguf)
from miotts_tpu_torch.models.sampling import SamplerParams, SamplerState, sample_token
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
    """At bf16 each package is ~0.05-0.07 from the f32 logits (|x| <= 3.4
    here). The dense head now writes f32 sums as JAX's does, so the two
    heads agree to 1e-5 on the same hidden state; what remains (0.093
    measured) is bf16 rounding inside the layers (XLA:CPU rounds silu's
    exp, add and divide each to bf16, the port silu once), hence atol 0.12.
    The port's distance from f32 stays within twice JAX's own."""
    jcfg, jw, ref = _jax_prefill(tiny_llm, jnp.bfloat16)
    _, _, ref32 = _jax_prefill(tiny_llm, jnp.float32)
    cfg, w, _ = load_llm_gguf(tiny_llm, CPU, torch.bfloat16)
    toks, lens = _prompts()
    last, _, _ = llm_prefill_kv(cfg, w, torch.from_numpy(toks), torch.from_numpy(lens))
    assert last.dtype == torch.float32
    np.testing.assert_allclose(last.numpy(), ref, atol=0.12, rtol=0)
    assert np.abs(last.numpy() - ref32).max() <= 2 * np.abs(ref - ref32).max()
    xn = np.random.RandomState(4).randn(2, cfg.dim).astype(np.float32)
    head = np.asarray(jllm._logits_matmul(jcfg, jw, jnp.asarray(xn, jnp.bfloat16)))
    got = _logits(cfg, w, torch.from_numpy(xn).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), head, atol=1e-5, rtol=0)


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
    state = SamplerState(torch.from_numpy(ring).long(), 4)
    got = sample_token(torch.from_numpy(logits), SamplerParams(**params), state,
                       torch.Generator().manual_seed(0))
    assert got.tolist() == np.asarray(ref).tolist()


def test_sampler_distribution_matches_softmax():
    """Distributional conformance (the port's counterpart of
    test_sampler_distribution_matches_softmax)."""
    logits = torch.tensor([[0.0, 1.0, 2.0]]).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    toks = sample_token(logits, SamplerParams(temp=1.0, top_k=0, top_p=1.0),
                        SamplerState.init(4000, CPU), gen)
    counts = np.bincount(toks.numpy(), minlength=3) / 4000
    expect = np.exp([0, 1, 2]) / np.exp([0, 1, 2]).sum()
    np.testing.assert_allclose(counts, expect, atol=0.03)


def test_sampler_state_ring():
    state = SamplerState.init(2, CPU)
    for i in range(70):
        state.update(torch.tensor([i, 100 + i]))
    assert state.idx == 70
    assert sorted(state.ring[0].tolist()) == list(range(6, 70))
