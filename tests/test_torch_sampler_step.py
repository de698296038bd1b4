"""The served decode step's sampler and bookkeeping (``sampling.sample_step_plain``;
kernel K10, ``ops/cuda/llm_fused.py sample_step``, on CUDA) on the CPU,
where the wrapper takes the plain version.

The plain version equals, bit for bit, the chain that the served chunk
body of ``models/llm.py`` ran inline before K10 (copied below as the oracle,
``_chunk_before``, with ``sample_token_batched`` as it stands): the tokens,
the output columns, the ring and its cursor, the keys, done, the counts and
pos, over a chunk of steps on mixed lanes (every knob of the grid, rings
empty, part filled and holding duplicates, lanes already done, an EOG and a
budget hit on the way). The chunk body itself, on a tiny LLM, gives the
oracle's tokens and state at full width and width-sliced, and the CLI's
chunk (``sampling.sample_chain_step`` in the same loop) gives the tokens
and state of the CLI's own loop before the two loops became one, its
whole-vocabulary settings included. K10's argument
checks run here on CPU tensors (``check_sample_step``); the kernel itself
is held to the plain version on the card (``chip_smoke.py check_sampler``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from miotts_tpu_torch.models import llm as llm_mod
from miotts_tpu_torch.models.llm import GenState, llm_decode_step, load_llm_gguf
from miotts_tpu_torch.models.sampling import (
    MAX_TOP_K, PENALTY_LAST_N, BatchSamplerParams, SamplerParams, SamplerState, sample_step_plain,
    sample_token, sample_token_batched, sampler_key, sampler_keys, uniform_lanes)
from miotts_tpu_torch.ops.cuda import llm_fused
from miotts_tpu_torch.ops.cuda.llm_fused import check_sample_step, sample_step
from miotts_tpu_torch.testing import write_synthetic_llm_gguf

torch.set_num_threads(1)
CPU = torch.device("cpu")

# lanes of the knob grid: (temp, top_k, top_p, repeat_penalty)
TEMPS = (0.0, 0.8)
TOP_KS = (1, 50, 256, 0, 300)
TOP_PS = (1.0, 0.9)
PENALTIES = (1.0, 1.3)


def _sample_before(logits, params, state, key):
    """``sample_token_batched`` as the chunk body called it before K10."""
    B, V = logits.shape
    pen = params.repeat_penalty[:, None]
    presence = torch.zeros((B, V + 1), dtype=torch.bool, device=logits.device)
    presence.scatter_(1, torch.where(state.ring >= 0, state.ring, torch.full_like(state.ring, V)),
                      True)
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    logits = torch.where(presence[:, :V] & (pen != 1.0), penalized, logits)

    K = min(MAX_TOP_K, V)
    vals, idx = torch.topk(logits, K, dim=-1)
    rank = torch.arange(K, dtype=torch.int32, device=logits.device)[None, :]
    k_eff = torch.where(params.top_k > 0, params.top_k.clamp(max=K), K)
    vals = vals.masked_fill(rank >= k_eff[:, None], float("-inf"))
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p_on = (params.top_p > 0.0) & (params.top_p < 1.0)
    keep = ((cum - probs) < params.top_p[:, None]) | ~p_on[:, None]
    keep[:, 0] = True
    vals = vals.masked_fill(~keep, float("-inf"))

    greedy = torch.argmax(vals, dim=-1)
    temp = params.temp.clamp(min=1e-6)[:, None]
    sampled = torch.argmax(vals / temp - torch.log(-torch.log(uniform_lanes(key, K))), dim=-1)
    choice = torch.where(params.temp <= 0.0, greedy, sampled)
    return torch.gather(idx, 1, choice[:, None])[:, 0]


def _chunk_before(decode, eog_ids, n_steps, sampler, rem, state, out, n_new):
    """The served chunk body before K10, verbatim but for ``decode`` in
    the place of ``llm_decode_step`` (``decode(tok, pos)`` -> logits)."""
    sstate = SamplerState(state.ring, state.ring_idx)
    done = state.done
    count = torch.zeros_like(n_new)
    toks = []
    for _ in range(n_steps):
        tok = _sample_before(state.logits, sampler, sstate, state.key)
        state.key[:, 1].add_(1)
        sstate.update(tok)
        toks.append(torch.where(done, torch.zeros_like(tok), tok))
        count = count + (~done).to(count.dtype)
        done = done | (tok[:, None] == eog_ids[None, :]).any(dim=-1) | (count >= rem)
        state.logits.copy_(decode(tok, state.pos))
        state.pos.add_((~done).to(torch.int32))
    state.done.copy_(done)
    out.copy_(torch.stack(toks, dim=1))
    n_new.copy_(count)


def _chunk_now(decode, eog_ids, n_steps, sampler, rem, state, out, n_new):
    """The served chunk body's loop as it is, with ``decode`` as above."""
    sstate = SamplerState(state.ring, state.ring_idx)
    n_new.zero_()
    for s in range(n_steps):
        tok, adv = sample_step(state.logits, sampler, sstate, state.key, eog_ids, rem,
                               state.done, n_new, out[:, s])
        state.logits.copy_(decode(tok, state.pos))
        state.pos.add_(adv)


def _grid_lanes(temp: float, top_p: float, penalty: float, V: int, seed: int):
    """Lanes for one (temp, top_p, penalty) of the grid, one a top_k plus a
    lane already done, with rings empty, part filled and with duplicates;
    the state, the sampler, an eog list that the greedy lane hits on its
    second token, and budgets with one lane's hit on the way."""
    rng = np.random.RandomState(seed)
    B = len(TOP_KS) + 1
    table = torch.from_numpy((rng.randn(97, V) * 3).astype(np.float32))

    def decode(tok, pos):
        return table[(tok * 7 + pos.long() * 3) % table.shape[0]]

    logits = torch.from_numpy((rng.randn(B, V) * 3).astype(np.float32))
    ring = torch.full((B, PENALTY_LAST_N), -1, dtype=torch.int64)
    ring[1, :10] = torch.from_numpy(rng.randint(0, V, 10))  # part filled
    ring[2] = torch.from_numpy(rng.randint(0, 4, PENALTY_LAST_N))  # duplicates
    ring[2, 0] = torch.argmax(logits[2])  # the lane's best, penalised once
    ring[3] = torch.from_numpy(rng.randint(0, V, PENALTY_LAST_N))  # full
    top_ks = list(TOP_KS) + [50]
    sampler = BatchSamplerParams.make([temp] * B, top_ks, [top_p] * B, [penalty] * B, CPU)
    pos = torch.from_numpy(rng.randint(0, 50, B).astype(np.int32))
    done = torch.zeros(B, dtype=torch.bool)
    done[-1] = True
    key = sampler_keys(rng.randint(0, 2**32, B), CPU)
    key[:, 1] = torch.from_numpy(rng.randint(0, 1000, B))
    state = GenState(logits, None, None, pos, ring, torch.tensor(61, dtype=torch.int32), done,
                     key)
    # lane 0 (top_k 1: its argmax after the penalty) emits the eog on its
    # second token; lane 4 runs out of budget on its third
    first = _sample_before(logits[:1], BatchSamplerParams.make([0.0], [1], [1.0], [penalty], CPU),
                           SamplerState(ring[:1].clone(), torch.tensor(61, dtype=torch.int32)),
                           key[:1])
    second = decode(first, pos[:1])
    eog = torch.tensor([int(torch.argmax(second[0])), V + 5], dtype=torch.int64)
    rem = torch.full((B,), 1 << 30, dtype=torch.int32)
    rem[4] = 3
    return decode, state, sampler, eog, rem


def _clone(state: GenState) -> GenState:
    return GenState(*(t.clone() if torch.is_tensor(t) else t
                      for t in dataclasses.astuple(state)))


def _assert_states_equal(a: GenState, b: GenState) -> None:
    for name in ("logits", "pos", "ring", "ring_idx", "done", "key"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("V", [100, 1000])
@pytest.mark.parametrize("penalty", PENALTIES)
@pytest.mark.parametrize("top_p", TOP_PS)
@pytest.mark.parametrize("temp", TEMPS)
def test_sample_step_plain_is_the_chain_before(temp, top_p, penalty, V):
    """A chunk of 12 steps through ``sample_step_plain`` gives the inline
    chain's tokens, counts and state bit for bit on every lane of the grid."""
    decode, state, sampler, eog, rem = _grid_lanes(temp, top_p, penalty, V, seed=V + int(temp))
    n_steps = 12
    ref, got = _clone(state), _clone(state)
    B = state.pos.shape[0]
    out_r, out_g = (torch.full((B, n_steps), -7, dtype=torch.int64) for _ in range(2))
    n_r, n_g = (torch.full((B,), -7, dtype=torch.int32) for _ in range(2))
    _chunk_before(decode, eog, n_steps, sampler, rem, ref, out_r, n_r)
    _chunk_now(decode, eog, n_steps, sampler, rem, got, out_g, n_g)
    assert torch.equal(out_g, out_r) and torch.equal(n_g, n_r)
    _assert_states_equal(got, ref)
    # the grid did what it was made for: lane 0 stopped at the eog, lane 4
    # on its budget, the done lane emitted nothing
    assert bool(ref.done[0]) and int(n_r[0]) == 2 and int(out_r[0, 1]) == int(eog[0])
    assert int(n_r[4]) == 3 and bool(ref.done[4])
    assert int(n_r[-1]) == 0 and not out_r[-1].any()


def test_sample_step_on_cpu_is_the_plain_version_and_counts_nothing():
    """The wrapper gives a CPU tensor to ``sample_step_plain``: no launch
    is counted."""
    decode, state, sampler, eog, rem = _grid_lanes(0.8, 0.9, 1.3, 300, seed=5)
    before = llm_fused.SAMPLE_STEP.launches
    a, b = _clone(state), _clone(state)
    B = state.pos.shape[0]
    outs = [torch.zeros(B, dtype=torch.int64) for _ in range(2)]
    counts = [torch.zeros(B, dtype=torch.int32) for _ in range(2)]
    tok_a, adv_a = sample_step(a.logits, sampler, SamplerState(a.ring, a.ring_idx), a.key, eog,
                               rem, a.done, counts[0], outs[0])
    tok_b, adv_b = sample_step_plain(b.logits, sampler, SamplerState(b.ring, b.ring_idx), b.key,
                                     eog, rem, b.done, counts[1], outs[1])
    assert torch.equal(tok_a, tok_b) and torch.equal(adv_a, adv_b)
    assert torch.equal(outs[0], outs[1]) and torch.equal(counts[0], counts[1])
    _assert_states_equal(a, b)
    assert adv_a.dtype == torch.int32 and tok_a.dtype == torch.int64
    assert llm_fused.SAMPLE_STEP.launches == before


def test_sample_token_batched_is_unchanged():
    """The chunk body's sampler call, ``sample_token_batched``, still
    picks what the copy above picks (every lane of the grid)."""
    for temp in TEMPS:
        _, state, sampler, _, _ = _grid_lanes(temp, 0.9, 1.3, 1000, seed=11)
        got = sample_token_batched(state.logits, sampler,
                                   SamplerState(state.ring, state.ring_idx), state.key)
        want = _sample_before(state.logits, sampler, SamplerState(state.ring, state.ring_idx),
                              state.key)
        assert torch.equal(got, want)


# -- the chunk body on a tiny LLM ----------------------------------------------------

@pytest.fixture(scope="module")
def tiny_llm(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sampler_step") / "llm.gguf")
    write_synthetic_llm_gguf(path, n_audio=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                             ffn=128, seed=4)
    cfg, w, _ = load_llm_gguf(path, CPU, torch.float32)
    return cfg, w


@pytest.mark.parametrize("sliced", [False, True], ids=["full", "sliced"])
def test_chunk_body_gives_the_chain_before(tiny_llm, sliced):
    """The served chunk (``llm.chunk`` with a ``BatchSamplerParams``, and
    its width-sliced form) on a tiny LLM: the tokens, counts and state of
    the chain before K10, with the decode step between (4 lanes, mixed
    knobs, one lane done, budgets)."""
    cfg, w = tiny_llm
    B, S, n_steps = 4, 64, 10
    state = llm_mod.init_batched_state(cfg, B, S, CPU, seed=3)
    rng = np.random.RandomState(2)
    tokens = torch.from_numpy(rng.randint(0, 200, (3, 6)))
    lengths = np.array([6, 4, 5], np.int32)
    logits, k, v = llm_mod.llm_prefill_kv(cfg, w, tokens, torch.from_numpy(lengths))
    llm_mod.attach_lanes(state, [0, 1, 3], logits, k, v, lengths, [11, 12, 13])
    sampler = BatchSamplerParams.make([0.0, 0.8, 0.0, 0.8], [50, 0, 50, 300], [1.0, 0.9, 1.0, 1.0],
                                      [1.3, 1.0, 1.0, 1.3], CPU)
    eog = torch.tensor([-1], dtype=torch.int64)
    rem = torch.tensor([1 << 30, 4, 1 << 30, 7], dtype=torch.int32)
    ref = _clone(state)
    ref.cache_k, ref.cache_v = state.cache_k.clone(), state.cache_v.clone()
    out_r = torch.empty((B, n_steps), dtype=torch.int64)
    n_r = torch.empty((B,), dtype=torch.int32)

    def decode(tok, pos):
        return llm_decode_step(cfg, w, tok, pos, ref.cache_k, ref.cache_v)

    lanes = torch.tensor([0, 3, B + 2, 1], dtype=torch.int64) if sliced else None  # pad: lane 2
    out, n_new = llm_mod.chunk(cfg, w, eog, n_steps, sampler, state, rem=rem, lanes=lanes).run()
    _chunk_before(decode, eog, n_steps, sampler, rem, ref, out_r, n_r)
    assert torch.equal(out, out_r) and torch.equal(n_new, n_r)
    _assert_states_equal(state, ref)
    assert torch.equal(state.cache_k, ref.cache_k) and torch.equal(state.cache_v, ref.cache_v)
    assert int(n_r[1]) == 4 and int(n_r[2]) == 0


def _cli_chunk_before(cfg, w, eog_ids, n_steps, sampler, state, out, n_new):
    """The CLI's chunk body before the served and the CLI's loops became
    one, verbatim."""
    sstate = SamplerState(state.ring, state.ring_idx)
    done = state.done
    count = torch.zeros_like(n_new)
    toks = []
    for _ in range(n_steps):
        tok = sample_token(state.logits, sampler, sstate, state.key)
        state.key[1:].add_(1)
        sstate.update(tok)
        toks.append(torch.where(done, torch.zeros_like(tok), tok))
        count = count + (~done).to(count.dtype)
        done = done | (tok[:, None] == eog_ids[None, :]).any(dim=-1)
        state.logits.copy_(llm_decode_step(cfg, w, tok, state.pos, state.cache_k, state.cache_v))
        state.pos.add_((~done).to(torch.int32))
    state.done.copy_(done)
    out.copy_(torch.stack(toks, dim=1))
    n_new.copy_(count)


@pytest.mark.parametrize("sampler", [
    SamplerParams(temp=0.8, top_k=300, repeat_penalty=1.3, seed=5),  # above the served pool
    SamplerParams(temp=0.9, top_k=0, top_p=0.9, seed=6),  # top-p over the whole vocabulary
    SamplerParams(temp=0.0, top_k=50, repeat_penalty=1.1),
], ids=["top_k_300", "top_k_0_top_p", "greedy"])
def test_cli_chunk_gives_the_loop_before(tiny_llm, sampler):
    """The CLI's chunk (``llm.chunk`` with a ``SamplerParams``: the one loop
    with ``sample_chain_step``) on a ragged pair of prompts and one key, two
    chunks of 9 steps with an EOG hit on the way: the tokens, counts and
    state, cache included, of the CLI's own loop before, bit for bit."""
    cfg, w = tiny_llm
    assert cfg.vocab_size > 300
    B, S, n_steps = 2, 64, 9
    rng = np.random.RandomState(8)
    tokens = torch.from_numpy(rng.randint(0, 200, (B, 7)))
    lengths = torch.tensor([7, 4], dtype=torch.int32)
    state = llm_mod.llm_start(cfg, w, tokens, lengths, *llm_mod.init_kv_cache(cfg, B, S, CPU),
                              sampler_key(sampler.seed, CPU))
    ref = _clone(state)
    ref.cache_k, ref.cache_v = state.cache_k.clone(), state.cache_v.clone()
    probe = _clone(ref)
    probe.cache_k, probe.cache_v = ref.cache_k.clone(), ref.cache_v.clone()
    out_r = torch.empty((B, n_steps), dtype=torch.int64)
    n_r = torch.empty((B,), dtype=torch.int32)
    _cli_chunk_before(cfg, w, torch.tensor([-1]), n_steps, sampler, probe, out_r, n_r)
    eog = torch.tensor([int(out_r[0, 4])])  # lane 0 stops at its fifth token
    ch = llm_mod.chunk(cfg, w, eog, n_steps, sampler, state)
    for _ in range(2):
        out, n_new = ch.run()
        _cli_chunk_before(cfg, w, eog, n_steps, sampler, ref, out_r, n_r)
        assert torch.equal(out, out_r) and torch.equal(n_new, n_r)
        _assert_states_equal(state, ref)
        assert torch.equal(state.cache_k, ref.cache_k) and torch.equal(state.cache_v, ref.cache_v)
    assert bool(ref.done[0])


# -- K10's argument checks -------------------------------------------------------------

def _valid(B=4, V=1000):
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(B, V).astype(np.float32))
    params = BatchSamplerParams.make([0.8] * B, [50] * B, [1.0] * B, [1.0] * B, CPU)
    state = SamplerState.init(B, CPU)
    return dict(logits=logits, params=params, state=state, key=sampler_keys(range(B), CPU),
                eog_ids=torch.tensor([3], dtype=torch.int64),
                rem=torch.full((B,), 9, dtype=torch.int32), done=torch.zeros(B, dtype=torch.bool),
                count=torch.zeros(B, dtype=torch.int32),
                out=torch.zeros((B, 5), dtype=torch.int64)[:, 2])


def _with(**changes):
    args = _valid()
    for name, fn in changes.items():
        args[name] = fn(args)
    return args


REFUSED = {
    "logits_f16": dict(logits=lambda a: a["logits"].half()),
    "logits_not_contiguous": dict(logits=lambda a: a["logits"].t().contiguous().t()),
    "logits_1d": dict(logits=lambda a: a["logits"][0]),
    "lanes_over_the_limit": dict(logits=lambda a: torch.zeros((llm_fused.SAMPLE_MAX_LANES + 1, 8))),
    "vocab_over_the_limit": dict(logits=lambda a: torch.zeros((1, llm_fused.SAMPLE_MAX_VOCAB + 1))),
    "ring_int32": dict(state=lambda a: SamplerState(a["state"].ring.int(), a["state"].idx)),
    "cursor_int64": dict(state=lambda a: SamplerState(a["state"].ring, a["state"].idx.long())),
    "key_flat": dict(key=lambda a: a["key"].reshape(-1)),
    "top_k_int64": dict(params=lambda a: dataclasses.replace(a["params"],
                                                            top_k=a["params"].top_k.long())),
    "temp_wrong_size": dict(params=lambda a: dataclasses.replace(a["params"],
                                                                temp=a["params"].temp[:2])),
    "done_uint8": dict(done=lambda a: a["done"].to(torch.uint8)),
    "count_int64": dict(count=lambda a: a["count"].long()),
    "rem_strided": dict(rem=lambda a: torch.zeros((4, 2), dtype=torch.int32)[:, 0]),
    "eog_int32": dict(eog_ids=lambda a: a["eog_ids"].int()),
    "out_int32": dict(out=lambda a: a["out"].int()),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_check_sample_step_refuses(case):
    with pytest.raises(ValueError, match="sample_step"):
        check_sample_step(**_with(**REFUSED[case]))


@pytest.mark.parametrize("B", [1, 8, 64])
def test_check_sample_step_takes_the_served_shapes(B):
    """The server's lanes (``-np``), the vocabulary of the 0.1B LLM, a
    strided column of the chunk's tokens and an empty eog list pass."""
    args = _valid(B=B, V=151759)
    args["eog_ids"] = torch.zeros((0,), dtype=torch.int64)
    check_sample_step(**args)
