"""The K11 family (``ops/cuda/llm_gemv.py``: the decode step's bf16 GEMVs
with their glue folded in) on the CPU, where each wrapper takes its plain
version.

Each plain version equals, bit for bit, the unfused chain it replaces: the
residual stream's ``rms_norm``, the product, and K8's, K7's or K9's plain
expressions after it, or the dense head. The decode step on the K11 route
(``_decode_step_gemv``) equals the step before the fusion
(``test_torch_llm_fused._step_before``) bit for bit. ``gemv_route`` picks
the route only for a CUDA step of at most 8 rows on dense bf16 fused
leaves without a tp group or q_norm. The kernels themselves are held to
these plain versions on the card (``chip_smoke.check_gemv``)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from miotts_tpu_torch.models import llm as llm_mod
from miotts_tpu_torch.models.llm import (
    _decode_step_gemv, gemv_route, init_kv_cache, kv_parts, llm_prefill, load_llm_gguf)
from miotts_tpu_torch.ops.cuda import graphs, llm_gemv
from miotts_tpu_torch.ops.cuda.llm_fused import rope_inv_freq
from miotts_tpu_torch.ops.cuda.llm_gemv import (
    KERNELS, gemv_residual, norm_gateup, norm_head, norm_qkv, split_k)
from miotts_tpu_torch.parallel.mesh import (
    LOGICAL_ENV, logical_devices, make_mesh, shard_llm_weights)
from miotts_tpu_torch.testing import write_synthetic_llm_gguf

from test_torch_llm_fused import _bf16, _qkv_before, _rms_norm_before, _step_before

torch.set_num_threads(1)
CPU = torch.device("cpu")
BF16 = torch.bfloat16


def _norm_w(rng, D):
    return torch.from_numpy(1.0 + rng.randn(D).astype(np.float32) * 0.05).to(BF16).float()


# ---------------------------------------------------------------------------
# the plain versions against the unfused chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("neox", [True, False])
def test_norm_qkv_plain(B, with_bias, neox):
    rng = np.random.RandomState(20 * B + 2 * with_bias + neox)
    D, H, KVH, HD, S = 64, 4, 2, 16, 40
    N = (H + 2 * KVH) * HD
    x = _bf16(rng, B, 1, D, scale=2.0)
    nw = _norm_w(rng, D)
    w = _bf16(rng, D, N, scale=0.1)
    bias = _bf16(rng, N, scale=0.05) if with_bias else None
    # lanes at 0, mid-cache, S - 1 and S (no row written), as many as B holds
    pos = torch.tensor([0, 17, S - 1, S, 23, S + 7, 5, 31][:B], dtype=torch.int32)
    ck, cv = _bf16(rng, B, S, KVH, HD), _bf16(rng, B, S, KVH, HD)
    want_k, want_v = ck.clone(), cv.clone()
    x0 = x.clone()
    want = _qkv_before(_rms_norm_before(x, nw, 1e-6) @ w, bias, pos, want_k, want_v, H, neox,
                       10000.0)
    got = norm_qkv(x, nw, 1e-6, w, bias, rope_inv_freq(HD, 10000.0, CPU), pos, ck, cv, H, neox)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_) and g.dtype == BF16 and g.is_contiguous()
    assert torch.equal(ck, want_k) and torch.equal(cv, want_v)
    assert torch.equal(x, x0)  # the residual stream is read, not written


@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("K", [48, 128])
def test_gemv_residual_plain(B, K):
    rng = np.random.RandomState(B + K)
    N = 64
    act = _bf16(rng, B, 1, K)
    w = _bf16(rng, K, N, scale=0.1)
    x = _bf16(rng, B, 1, N, scale=3.0)
    want = x + act @ w
    assert gemv_residual(act, w, x) is None
    assert torch.equal(x, want) and x.dtype == BF16


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_norm_gateup_plain(B):
    rng = np.random.RandomState(30 + B)
    D, Fd = 64, 96
    x = _bf16(rng, B, 1, D, scale=2.0)
    nw = _norm_w(rng, D)
    w = _bf16(rng, D, 2 * Fd, scale=0.2)
    gu = _rms_norm_before(x, nw, 1e-6) @ w
    want = F.silu(gu[..., :Fd]) * gu[..., Fd:]
    got = norm_gateup(x, nw, 1e-6, w, Fd)
    assert torch.equal(got, want) and got.shape == (B, 1, Fd)


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_norm_head_plain(B):
    rng = np.random.RandomState(40 + B)
    D, V = 64, 300
    x = _bf16(rng, B, 1, D, scale=2.0)
    nw = _norm_w(rng, D)
    head = _bf16(rng, V, D, scale=0.1)
    want = _rms_norm_before(x, nw, 1e-6)[:, 0].float() @ head.float().t()
    got = norm_head(x, nw, 1e-6, head)
    assert torch.equal(got, want) and got.dtype == torch.float32 and got.shape == (B, V)


def test_split_k_plans_the_served_shapes():
    """The 0.1B LLM's leaves: wqkv and wo in 8-CTA clusters of 6 k-steps,
    w_gateup in 4-CTA clusters of 12, w_down in 8-CTA clusters of 16; every
    plan covers K, within 8 CTAs a cluster and 16 k-steps a CTA."""
    assert split_k(768, 16) == (8, 6)  # wqkv: 16 heads
    assert split_k(768, 12) == (8, 6)  # wo
    assert split_k(768, 64) == (4, 12)  # w_gateup: 2048 / 32 tiles
    assert split_k(2048, 12) == (8, 16)  # w_down
    for K in range(16, llm_gemv.MAX_K + 1, 16):
        for tiles in (1, 12, 16, 64, 300):
            split, steps = split_k(K, tiles)
            assert 1 <= split <= 8 and steps <= 16 and split * steps * 16 >= K


def test_other_devices_are_refused():
    meta = torch.empty((2, 1, 64), dtype=BF16, device="meta")
    nw = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        norm_gateup(meta, nw, 1e-6, torch.empty((64, 128), dtype=BF16, device="meta"), 64)
    with pytest.raises(ValueError, match="unsupported device"):
        norm_head(meta, nw, 1e-6, torch.empty((100, 64), dtype=BF16, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        gemv_residual(meta, torch.empty((64, 64), dtype=BF16, device="meta"), meta)
    with pytest.raises(ValueError, match="unsupported device"):
        norm_qkv(meta, nw, 1e-6, torch.empty((64, 256), dtype=BF16, device="meta"), None,
                 torch.empty(32, device="meta"), torch.empty(2, dtype=torch.int32, device="meta"),
                 torch.empty((2, 8, 1, 64), dtype=BF16, device="meta"),
                 torch.empty((2, 8, 1, 64), dtype=BF16, device="meta"), 2, True)


# ---------------------------------------------------------------------------
# the decode step on the K11 route against the step before the fusion
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gemv") / "tiny_llm.gguf")
    write_synthetic_llm_gguf(path, n_audio=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                             ffn=64, seed=0)
    return path


@pytest.fixture(scope="module")
def llama_path(tmp_path_factory):
    """arch llama: adjacent-pair RoPE."""
    path = str(tmp_path_factory.mktemp("gemv_llama") / "tiny_llm.gguf")
    write_synthetic_llm_gguf(path, n_audio=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                             ffn=64, seed=4, arch="llama")
    return path


@pytest.fixture(scope="module")
def hd64_path(tmp_path_factory):
    """head_dim 64, the shapes the kernels take."""
    path = str(tmp_path_factory.mktemp("gemv_hd64") / "llm.gguf")
    write_synthetic_llm_gguf(path, n_audio=64, dim=128, n_layers=1, n_heads=2, n_kv_heads=1,
                             ffn=128, seed=5)
    return path


def _gemv_steps_equal(cfg, w, B, S=24, steps=3):
    """Prefill B lanes, then ``steps`` decode steps at ragged positions (one
    lane reaching S - 1, then S), once by ``_decode_step_gemv`` and once by
    the step before the fusion from a copy of the same caches: logits and
    caches equal bit for bit each step."""
    rng = np.random.RandomState(100 + B)
    T = 8
    tokens = torch.from_numpy(rng.randint(0, 200, (B, T)))
    lengths = torch.tensor(([T, 5, 3, 7] * 2)[:B], dtype=torch.int32)
    ck, cv = init_kv_cache(cfg, B, S, CPU, w=w)
    llm_prefill(cfg, w, tokens, lengths, ck, cv)
    rk, rv = ck.clone(), cv.clone()
    pos = lengths.clone()
    pos[-1] = S - 2
    for step in range(steps):
        tok = torch.from_numpy(rng.randint(0, 200, B))
        got = _decode_step_gemv(cfg, w, tok, pos, ck, cv)
        want = _step_before(cfg, w, tok, pos, rk, rv)
        assert torch.equal(got, want), f"step {step}"
        assert torch.equal(ck, rk) and torch.equal(cv, rv), f"step {step}: cache"
        pos += 1


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_decode_step_gemv_dense_bf16(tiny_path, B):
    cfg, w, _ = load_llm_gguf(tiny_path, CPU, BF16)
    assert cfg.has_qkv_bias and cfg.rope_neox and cfg.tie_embeddings is False
    _gemv_steps_equal(cfg, w, B)


def test_decode_step_gemv_adjacent_pairs_tied_head(llama_path):
    """Adjacent-pair RoPE, no bias, and the head tied to the embedding."""
    cfg, w, _ = load_llm_gguf(llama_path, CPU, BF16)
    assert not cfg.rope_neox
    _gemv_steps_equal(cfg, w, 4)
    _gemv_steps_equal(dataclasses.replace(cfg, tie_embeddings=True),
                      dict(w, bqkv=None, output=None), 2)


def test_decode_step_gemv_quantized_head(tiny_path):
    """``--llm-quant output``: dense layer leaves on the K11 route, the Q8_0
    head after the output norm (K7) on K3."""
    cfg, w, _ = load_llm_gguf(tiny_path, CPU, BF16, quantize="output")
    assert isinstance(w["output"], dict) and w["wqkv"].dtype == BF16
    _gemv_steps_equal(cfg, w, 2)


# ---------------------------------------------------------------------------
# the route chooser
# ---------------------------------------------------------------------------

CUDA = torch.device("cuda")


def test_gemv_route_takes_dense_bf16_fused_steps(hd64_path):
    cfg, w, _ = load_llm_gguf(hd64_path, CPU, BF16)
    assert cfg.head_dim == 64
    for rows in range(1, 9):
        assert gemv_route(cfg, w, rows, CUDA)
    assert gemv_route(cfg, w, 4, "cuda:0")
    # the quantized head alone: the layers take K11
    cfg_o, w_o, _ = load_llm_gguf(hd64_path, CPU, BF16, quantize="output")
    assert isinstance(w_o["output"], dict) and gemv_route(cfg_o, w_o, 4, CUDA)


def test_gemv_route_keeps_every_other_step(hd64_path, tiny_path, tmp_path, monkeypatch):
    cfg, w, _ = load_llm_gguf(hd64_path, CPU, BF16)
    assert not gemv_route(cfg, w, 4, CPU)  # the CPU
    assert not gemv_route(cfg, w, 9, CUDA)  # 9 rows
    for quant in ("q8_0", "int8"):  # quantized leaves
        cfg_q, w_q, _ = load_llm_gguf(hd64_path, CPU, BF16, quantize=quant)
        assert isinstance(w_q["wqkv"], dict) and not gemv_route(cfg_q, w_q, 4, CUDA)
    cfg_f, w_f, _ = load_llm_gguf(hd64_path, CPU, torch.float32)  # f32 weights
    assert not gemv_route(cfg_f, w_f, 4, CUDA)
    norms = {k: torch.ones((cfg.n_layers, cfg.head_dim)) for k in ("q_norm", "k_norm")}
    assert not gemv_route(dataclasses.replace(cfg, has_qk_norm=True), dict(w, **norms), 4, CUDA)
    cfg_t, w_t, _ = load_llm_gguf(tiny_path, CPU, BF16)  # head_dim 8: shapes K11 does not take
    assert cfg_t.head_dim == 8 and not gemv_route(cfg_t, w_t, 4, CUDA)
    monkeypatch.setenv("MIOTTS_LLM_FUSE", "0")  # one leaf a projection
    cfg_u, w_u, _ = load_llm_gguf(hd64_path, CPU, BF16)
    assert w_u.get("wqkv") is None and not gemv_route(cfg_u, w_u, 4, CUDA)
    monkeypatch.delenv("MIOTTS_LLM_FUSE")
    # a tp group, on one card's logical ranks as over several
    monkeypatch.setenv(LOGICAL_ENV, "2")
    monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")
    path = str(tmp_path / "llm.gguf")
    write_synthetic_llm_gguf(path, n_audio=64, dim=256, n_layers=1, n_heads=4, n_kv_heads=2,
                             ffn=128, seed=3)
    cfg_g, w_g, _ = load_llm_gguf(path, CPU, BF16)
    assert gemv_route(cfg_g, w_g, 4, CUDA)
    g = shard_llm_weights(make_mesh(logical_devices("cpu")[:2], tp=2), w_g, cfg_g)[0]
    assert len(g.shards) == 2 and not gemv_route(cfg_g, g, 4, CUDA)


def test_cpu_steps_keep_the_k7_k9_route(hd64_path, monkeypatch):
    """On the CPU the decode step keeps today's route: ``_decode_step_gemv``
    is never entered."""
    cfg, w, _ = load_llm_gguf(hd64_path, CPU, BF16)

    def refuse(*a, **k):
        raise AssertionError("the K11 route was taken on the CPU")
    monkeypatch.setattr(llm_mod, "_decode_step_gemv", refuse)
    ck, cv = init_kv_cache(cfg, 2, 16, CPU)
    llm_mod.llm_decode_step(cfg, w, torch.tensor([1, 2]), torch.tensor([0, 3], dtype=torch.int32),
                            ck, cv)
    assert kv_parts(ck)[0].abs().sum() > 0


# ---------------------------------------------------------------------------
# the launch counters
# ---------------------------------------------------------------------------

def test_gemv_counters_count_launches_and_replays():
    """``graphs.launched`` counts a K11 kernel by its name, inside a capture
    into the graph's per-replay counts, which each replay adds; the CPU's
    plain versions count nothing."""
    assert [k.name for k in KERNELS] == ["norm_qkv", "gemv_residual", "norm_gateup", "norm_head"]
    assert all(k in graphs.counters() for k in KERNELS)
    before = [k.launches for k in KERNELS]
    rng = np.random.RandomState(0)
    x = _bf16(rng, 2, 1, 64)
    nw = _norm_w(rng, 64)
    norm_gateup(x, nw, 1e-6, _bf16(rng, 64, 128), 64)
    norm_head(x, nw, 1e-6, _bf16(rng, 50, 64))
    gemv_residual(_bf16(rng, 2, 1, 64), _bf16(rng, 64, 64), x)
    assert [k.launches for k in KERNELS] == before
    with graphs.record_launches() as per_replay:
        for k in KERNELS:
            graphs.launched(k.__name__)
        graphs.launched(llm_gemv.GEMV_RESIDUAL.__name__)
    assert [k.launches for k in KERNELS] == before
    assert [per_replay[k] for k in KERNELS] == [1, 2, 1, 1]
    graphs.count_replay(per_replay)
    graphs.count_replay(per_replay)
    assert [k.launches - b for k, b in zip(KERNELS, before)] == [2, 4, 2, 2]
    graphs.launched(llm_gemv.NORM_HEAD.__name__)
    assert llm_gemv.NORM_HEAD.launches == before[3] + 3
