"""The decode step's fused glue (``ops/cuda/llm_fused.py``, kernels K7-K9 on
CUDA) on the CPU, where each wrapper takes its plain version.

Each plain version equals, bit for bit, the expressions the decode step ran
before the fusion: the residual add and ``rms_norm``; the QKV bias add,
``ops/rope.apply_rope`` on q and k, the cache-dtype k/v, q in K2's layout
and the end-of-step cache scatter; ``F.silu(gate) * up``. The decode step
as a whole equals the step before the fusion (copied below as
``_step_before``) bit for bit: dense bf16 and f32, Q8_0 leaves (padded
columns), no QKV bias, adjacent-pair RoPE, unfused leaves, q_norm/k_norm
layers and a tensor-parallel group on logical CPU ranks. The kernels
themselves are held to these plain versions on the card (``chip_smoke.py``)."""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from miotts_tpu_torch.models import llm as llm_mod
from miotts_tpu_torch.models.llm import (
    _embed, _layer, _layer_qkv, _logits, _mm, _rank_scope, _ranks, _row_parallel, _to,
    init_kv_cache, kv_parts, llm_decode_step, llm_prefill, load_llm_gguf)
from miotts_tpu_torch.ops.cuda import graphs, llm_fused
from miotts_tpu_torch.ops.cuda.decode_attention import decode_attention
from miotts_tpu_torch.ops.cuda.llm_fused import (
    KERNELS, add_rms_norm, qkv_rope_cache, rope_inv_freq, silu_mul)
from miotts_tpu_torch.ops.rope import apply_rope, rope_angles
from miotts_tpu_torch.parallel.mesh import (
    LOGICAL_ENV, logical_devices, make_mesh, shard_llm_weights)
from miotts_tpu_torch.testing import write_synthetic_llm_gguf

torch.set_num_threads(1)
CPU = torch.device("cpu")
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# the decode step before the fusion, verbatim but for its helpers' names
# ---------------------------------------------------------------------------

def _rms_norm_before(x, weight, eps):
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * weight).to(x.dtype)


def _ffn_before(cfg, cfgs, g, blks, x):
    acts = []
    for r, (rc, blk) in enumerate(zip(cfgs, blks)):
        with _rank_scope(g, r):
            fn = _rms_norm_before(_to(g, x, r), blk["ffn_norm"], rc.rms_eps)
            if blk["w_gateup"] is not None:
                gu = _mm(fn, blk["w_gateup"])
                gate, up = gu[..., :rc.ffn_dim], gu[..., rc.ffn_dim:2 * rc.ffn_dim]
            else:
                gate = _mm(fn, blk["w_gate"])[..., :rc.ffn_dim]
                up = _mm(fn, blk["w_up"])[..., :rc.ffn_dim]
            acts.append(F.silu(gate) * up)
    return _row_parallel(g, acts, blks, "w_down")[..., :cfg.dim]


def _step_before(cfg, w, token, pos, cache_k, cache_v):
    cfgs, shards, g = _ranks(cfg, w)
    B = token.shape[0]
    ck, cv = kv_parts(cache_k), kv_parts(cache_v)
    S = ck[0].shape[2]
    x = _embed(cfg, w, token)[:, None, :]
    pos_rs = [_to(g, pos, r) for r in range(len(shards))]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    new_ks, new_vs = [[] for _ in shards], [[] for _ in shards]
    for li in range(cfg.n_layers):
        blks, acts = [], []
        for r, (rc, sh) in enumerate(zip(cfgs, shards)):
            with _rank_scope(g, r):
                blk = _layer(sh, li)
                positions = pos_rs[r][:, None]
                q, k, v = _layer_qkv(rc, blk, _rms_norm_before(_to(g, x, r), blk["attn_norm"],
                                                               cfg.rms_eps))
                q = apply_rope(q, positions, cfg.rope_base, cfg.rope_neox)
                k = apply_rope(k, positions, cfg.rope_base, cfg.rope_neox)
                k1 = k[:, 0].to(ck[r].dtype).contiguous()
                v1 = v[:, 0].to(cv[r].dtype).contiguous()
                new_ks[r].append(k1)
                new_vs[r].append(v1)
                qh = q[:, 0].reshape(B, rc.n_kv_heads, rc.n_heads // rc.n_kv_heads,
                                     cfg.head_dim).contiguous()
                att = decode_attention(qh, k1, v1, ck[r][li], cv[r][li], scale,
                                       pos_rs[r]).to(x.dtype)
                acts.append(att[:, None, :])
                blks.append(blk)
        x = x + _row_parallel(g, acts, blks, "wo")[..., :cfg.dim]
        x = x + _ffn_before(cfg, cfgs, g, blks, x)
    for r in range(len(shards)):
        p_r = pos_rs[r]
        b_idx = torch.arange(B, device=p_r.device)
        in_range = (p_r < S)[None, :, None, None]
        p = torch.clamp(p_r.long(), max=S - 1)
        for cache, new in ((ck[r], torch.stack(new_ks[r])), (cv[r], torch.stack(new_vs[r]))):
            cache[:, b_idx, p] = torch.where(in_range, new, cache[:, b_idx, p])
    xn = _rms_norm_before(x, shards[0]["output_norm"], cfg.rms_eps)
    return _logits(cfg, w, xn[:, 0])


# ---------------------------------------------------------------------------
# the plain versions against the expressions they replace
# ---------------------------------------------------------------------------

def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(BF16)


@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("with_delta", [True, False])
def test_add_rms_norm_plain(B, with_delta):
    rng = np.random.RandomState(B)
    D = 96
    x = _bf16(rng, B, 1, D, scale=3.0)
    # the row-parallel sum of a padded quantized leaf: a strided slice
    delta = _bf16(rng, B, 1, D + 32)[..., :D] if with_delta else None
    weight = torch.from_numpy(1.0 + rng.randn(D).astype(np.float32) * 0.05).to(BF16).float()
    want_x = x + delta if with_delta else x.clone()
    want = _rms_norm_before(want_x, weight, 1e-6)
    got = add_rms_norm(x, delta, weight, 1e-6)
    assert torch.equal(got, want) and got.dtype == BF16
    assert torch.equal(x, want_x)  # the residual, updated in place


def _cache(rng, B, S, KVH, HD):
    return _bf16(rng, B, S, KVH, HD), _bf16(rng, B, S, KVH, HD)


def _qkv_before(qkv, bias, pos, cache_k, cache_v, H, neox, base):
    """The decode step's expressions before the fusion, for one layer."""
    B = qkv.shape[0]
    S, KVH, HD = cache_k.shape[1:]
    Hd, KVd = H * HD, KVH * HD
    qkv = qkv[..., :Hd + 2 * KVd]
    if bias is not None:
        qkv = qkv + bias
    q, k, v = qkv[..., :Hd], qkv[..., Hd:Hd + KVd], qkv[..., Hd + KVd:]
    q, k, v = (t.reshape(B, 1, n, HD) for t, n in ((q, H), (k, KVH), (v, KVH)))
    positions = pos[:, None]
    q = apply_rope(q, positions, base, neox)
    k = apply_rope(k, positions, base, neox)
    k1 = k[:, 0].to(cache_k.dtype).contiguous()
    v1 = v[:, 0].to(cache_v.dtype).contiguous()
    qh = q[:, 0].reshape(B, KVH, H // KVH, HD).contiguous()
    b_idx = torch.arange(B)
    in_range = (pos < S)[None, :, None, None]
    p = torch.clamp(pos.long(), max=S - 1)
    for cache, new in ((cache_k, k1), (cache_v, v1)):
        c = cache[None]
        c[:, b_idx, p] = torch.where(in_range, new[None], c[:, b_idx, p])
    return qh, k1, v1


@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("neox", [True, False])
def test_qkv_rope_cache_plain(B, with_bias, neox):
    rng = np.random.RandomState(10 * B + 2 * with_bias + neox)
    H, KVH, HD, S = 6, 2, 16, 40
    N = (H + 2 * KVH) * HD
    # a quantized leaf's padded product: N rounded up to 128
    qkv = _bf16(rng, B, 1, 256, scale=2.0)
    bias = _bf16(rng, N, scale=0.05) if with_bias else None
    # 0, mid-cache, S - 1 and past the end (S, S + 7), as many as B holds
    pos = torch.tensor([0, 17, S - 1, S, 23, S + 7, 5, 31][:B], dtype=torch.int32)
    ck, cv = _cache(rng, B, S, KVH, HD)
    ck0, cv0 = ck.clone(), cv.clone()
    want_k, want_v = ck.clone(), cv.clone()
    want = _qkv_before(qkv, bias, pos, want_k, want_v, H, neox, 10000.0)
    got = qkv_rope_cache(qkv, bias, rope_inv_freq(HD, 10000.0, CPU), pos, ck, cv, H, neox)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_) and g.dtype == BF16 and g.is_contiguous()
    assert got[0].shape == (B, KVH, H // KVH, HD)
    assert torch.equal(ck, want_k) and torch.equal(cv, want_v)
    for b in range(B):
        p = int(pos[b])
        if p >= S:  # the cache stays untouched
            assert torch.equal(ck[b], ck0[b]) and torch.equal(cv[b], cv0[b])
        else:
            assert torch.equal(ck[b, p], got[1][b]) and torch.equal(cv[b, p], got[2][b])
            keep = [s for s in range(S) if s != p]
            assert torch.equal(ck[b, keep], ck0[b, keep])


def test_rope_inv_freq_is_rope_angles_own():
    """The angle tables from the kept inverse frequencies equal
    ``rope_angles``', and the entry is computed once a (device, HD, base)."""
    pos = torch.tensor([0, 3, 700, 1023], dtype=torch.int32)
    for HD, base in ((64, 10000.0), (16, 1e6)):
        inv = rope_inv_freq(HD, base, CPU)
        assert inv is rope_inv_freq(HD, base, CPU)
        cos, sin = rope_angles(pos[:, None], HD, base)
        ang = pos[:, None].float()[..., None] * inv
        assert torch.equal(torch.cos(ang), cos) and torch.equal(torch.sin(ang), sin)


@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("pad", [0, 128])
def test_silu_mul_plain(B, pad):
    rng = np.random.RandomState(B + pad)
    Fd = 64
    gu = _bf16(rng, B, 1, 2 * Fd + pad, scale=4.0)
    got = silu_mul(gu, Fd)
    want = F.silu(gu[..., :Fd]) * gu[..., Fd:2 * Fd]
    assert torch.equal(got, want) and got.shape == (B, 1, Fd)


def test_other_devices_are_refused():
    meta = torch.empty((2, 1, 64), dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        add_rms_norm(meta, None, torch.empty(64, device="meta"), 1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        silu_mul(meta, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        qkv_rope_cache(meta, None, torch.empty(4, device="meta"),
                       torch.empty(2, dtype=torch.int32, device="meta"),
                       torch.empty((2, 8, 1, 8), dtype=BF16, device="meta"),
                       torch.empty((2, 8, 1, 8), dtype=BF16, device="meta"), 2, True)


# ---------------------------------------------------------------------------
# the decode step against the step before the fusion
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fused") / "tiny_llm.gguf")
    write_synthetic_llm_gguf(path, n_audio=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                             ffn=64, seed=0)
    return path


@pytest.fixture(scope="module")
def llama_path(tmp_path_factory):
    """arch llama: adjacent-pair RoPE."""
    path = str(tmp_path_factory.mktemp("fused_llama") / "tiny_llm.gguf")
    write_synthetic_llm_gguf(path, n_audio=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                             ffn=64, seed=4, arch="llama")
    return path


def _steps_equal(cfg, w, B=4, S=24, steps=3, dtype=BF16, device=CPU):
    """Prefill B lanes, then ``steps`` decode steps at ragged positions (one
    lane reaching S - 1, one at S and past it), once by the fused step and
    once by the step before the fusion from a copy of the same caches: the
    logits and every cache part equal bit for bit each step."""
    rng = np.random.RandomState(B)
    T = 8
    tokens = torch.from_numpy(rng.randint(0, 200, (B, T)))
    lengths = torch.tensor(([T, 5, 3, 7] * 2)[:B], dtype=torch.int32)
    ck, cv = init_kv_cache(cfg, B, S, device, dtype=dtype, w=w)
    llm_prefill(cfg, w, tokens, lengths, ck, cv)
    rk = tuple(c.clone() for c in kv_parts(ck))
    rv = tuple(c.clone() for c in kv_parts(cv))
    rk, rv = (rk[0], rv[0]) if len(rk) == 1 else (rk, rv)
    pos = lengths.clone()
    pos[-1] = S - 2  # reaches S - 1, then S
    for step in range(steps):
        tok = torch.from_numpy(rng.randint(0, 200, B))
        got = llm_decode_step(cfg, w, tok, pos, ck, cv)
        want = _step_before(cfg, w, tok, pos, rk, rv)
        assert torch.equal(got, want), f"step {step}"
        for a, b in zip(kv_parts(ck) + kv_parts(cv), kv_parts(rk) + kv_parts(rv)):
            assert torch.equal(a, b), f"step {step}: cache"
        pos += 1
    assert int(pos[-1]) == S - 2 + steps


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_decode_step_dense_bf16(tiny_path, B):
    cfg, w, _ = load_llm_gguf(tiny_path, CPU, BF16)
    assert cfg.has_qkv_bias and cfg.rope_neox and w["wqkv"] is not None
    _steps_equal(cfg, w, B=B)


def test_decode_step_f32_weights(tiny_path):
    cfg, w, _ = load_llm_gguf(tiny_path, CPU, torch.float32)
    _steps_equal(cfg, w)


def test_decode_step_without_bias_adjacent_pairs(llama_path):
    cfg, w, _ = load_llm_gguf(llama_path, CPU, BF16)
    assert not cfg.rope_neox
    _steps_equal(cfg, w)
    _steps_equal(cfg, dict(w, bqkv=None))


@pytest.mark.parametrize("quant", ["q8_0", "int8"])
def test_decode_step_quantized_leaves(tiny_path, quant):
    """Quantized leaves pad N to 128: K8 reads the padded QKV product's
    rows, K7 the padded row-parallel sum's slice."""
    cfg, w, _ = load_llm_gguf(tiny_path, CPU, BF16, quantize=quant)
    leaf = w["wqkv"]["q" if quant == "q8_0" else "q8"]
    assert leaf.shape[-1] == 128 > (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    _steps_equal(cfg, w)


def test_decode_step_unfused_leaves(tiny_path, monkeypatch):
    """MIOTTS_LLM_FUSE=0 (one leaf a projection) keeps the unfused
    expressions: neither K8 nor K9 is asked."""
    monkeypatch.setenv("MIOTTS_LLM_FUSE", "0")
    cfg, w, _ = load_llm_gguf(tiny_path, CPU, BF16)
    assert w.get("wqkv") is None and w.get("w_gateup") is None

    def refuse(*a, **k):
        raise AssertionError("a fused kernel's wrapper was called")
    monkeypatch.setattr(llm_mod, "qkv_rope_cache", refuse)
    monkeypatch.setattr(llm_mod, "silu_mul", refuse)
    _steps_equal(cfg, w)


def test_decode_step_qk_norm_keeps_the_expressions(tiny_path, monkeypatch):
    """A layer that carries q_norm/k_norm takes the unfused q/k/v
    expressions (decided from the weights), and still equals the step
    before the fusion."""
    cfg, w, _ = load_llm_gguf(tiny_path, CPU, BF16)
    rng = np.random.RandomState(7)
    norms = {k: torch.from_numpy(1.0 + rng.randn(cfg.n_layers, cfg.head_dim).astype(np.float32)
                                 * 0.1).to(BF16).float() for k in ("q_norm", "k_norm")}
    cfg = dataclasses.replace(cfg, has_qk_norm=True)
    w = dict(w, **norms)

    def refuse(*a, **k):
        raise AssertionError("qkv_rope_cache called for a q_norm layer")
    monkeypatch.setattr(llm_mod, "qkv_rope_cache", refuse)
    _steps_equal(cfg, w)


@pytest.mark.parametrize("quant", ["", "q8_0"])
def test_decode_step_tensor_parallel(tmp_path, monkeypatch, quant):
    """A tp=2 group on logical CPU ranks: the norms run once on the lead,
    each rank's q/k/v over its kv heads; its logits and cache parts equal
    the same group's step before the fusion bit for bit."""
    monkeypatch.setenv(LOGICAL_ENV, "2")
    monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")
    path = str(tmp_path / "llm.gguf")
    write_synthetic_llm_gguf(path, n_audio=64, dim=64, n_layers=2, n_heads=8, n_kv_heads=2,
                             ffn=128, seed=3)
    cfg, w, _ = load_llm_gguf(path, CPU, BF16, quantize=quant or None)
    g = shard_llm_weights(make_mesh(logical_devices("cpu")[:2], tp=2), w, cfg)[0]
    assert len(g.shards) == 2 and g.cfgs[0].n_kv_heads == 1
    _steps_equal(cfg, g, B=2)


# ---------------------------------------------------------------------------
# the launch counters
# ---------------------------------------------------------------------------

def test_fused_counters_count_launches_and_replays():
    """``graphs.launched`` counts a fused kernel by its name; inside a
    capture it counts into the graph's per-replay counts, which each replay
    adds; the CPU's plain versions count nothing."""
    assert [k.name for k in KERNELS] == ["add_rms_norm", "qkv_rope_cache", "silu_mul",
                                         "sample_step"]
    assert all(k in graphs.counters() for k in KERNELS)
    before = [k.launches for k in KERNELS]
    x = torch.zeros((2, 1, 16), dtype=BF16)
    add_rms_norm(x, None, torch.ones(16), 1e-6)
    silu_mul(torch.zeros((2, 1, 32), dtype=BF16), 16)
    assert [k.launches for k in KERNELS] == before
    k7 = llm_fused.ADD_RMS_NORM
    graphs.launched(k7.__name__)
    assert k7.launches == before[0] + 1
    with graphs.record_launches() as per_replay:
        graphs.launched(k7.__name__)
        graphs.launched(llm_fused.SILU_MUL.__name__)
    assert k7.launches == before[0] + 1
    assert per_replay[k7] == 1 and per_replay[llm_fused.SILU_MUL] == 1
    assert per_replay[llm_fused.QKV_ROPE_CACHE] == 0
    graphs.count_replay(per_replay)
    graphs.count_replay(per_replay)
    assert k7.launches == before[0] + 3
    with graphs.on_rank(1):
        graphs.launched(llm_fused.QKV_ROPE_CACHE.__name__)
    assert graphs.rank_launches[(llm_fused.QKV_ROPE_CACHE.__name__, 1)] >= 1
