"""The port's (dp, tp) mesh (miotts_tpu_torch/parallel/) on logical CPU
ranks (MIOTTS_LOGICAL_DEVICES=8, the counterpart of the JAX suite's 8 forced
host devices): the cases of tests/test_parallel.py, the tp forward against
one device (f32 at JAX's rtol = atol = 1e-5, int8 at its 1e-4, greedy tokens
equal, tp = 2 and 4, tp > n_kv_heads among them), and two holds against the
JAX package itself: each rank's leaves against the addressable shards of
``miotts_tpu.parallel.mesh.shard_llm_weights`` (MIOTTS_LLM_FUSE=0), and the
tp prefill's logits against JAX's sharded prefill (atol 1e-4, as the
port's single-device f32 prefill is held to JAX's)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.models import llm as jllm
from miotts_tpu.parallel import mesh as jmesh
from miotts_tpu_torch.models.llm import (
    GenState, init_batched_state, init_kv_cache, llm_decode_step, llm_generate, llm_prefill,
    llm_prefill_kv, load_llm_gguf)
from miotts_tpu_torch.models.sampling import SamplerParams, sampler_key
from miotts_tpu_torch.parallel import collectives
from miotts_tpu_torch.parallel.mesh import (
    LOGICAL_ENV, TPGroup, codec_data_sharding, gen_state_shardings, kv_heads, llm_data_shardings,
    llm_weight_shardings, logical_devices, make_mesh, parse_backend_devices, replicate_tree,
    shard_gen_state, shard_llm_weights)
from miotts_tpu_torch.testing import write_synthetic_llm_gguf

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def logical_ranks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(LOGICAL_ENV, "8")
        mp.setenv("MIOTTS_PLATFORM", "cpu")
        yield


def _devices(n):
    return logical_devices("cpu")[:n]


@pytest.fixture(scope="module")
def llm_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("tpar") / "llm.gguf"
    # dims divisible by tp=4: heads 8, kv 8 (tests/test_parallel.py)
    write_synthetic_llm_gguf(str(path), n_audio=64, dim=64, n_layers=2, n_heads=8,
                             n_kv_heads=8, ffn=128, seed=0)
    return str(path)


@pytest.fixture(scope="module")
def llm(llm_path):
    return load_llm_gguf(llm_path, CPU, torch.float32)


@pytest.fixture(scope="module")
def gqa_path(tmp_path_factory):
    """kv heads 2 under tp 4 (replicated kv heads), an even vocab (split)."""
    path = tmp_path_factory.mktemp("tgqa") / "llm.gguf"
    write_synthetic_llm_gguf(str(path), n_audio=64, dim=64, n_layers=2, n_heads=8,
                             n_kv_heads=2, ffn=128, seed=3, n_filler_vocab=1)
    return str(path)


def _prompts(seed, T, lens):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randint(0, 200, size=(2, T)).astype(np.int64)),
            torch.tensor(lens, dtype=torch.int32))


def _dp_prefill(cfg, groups, tokens, lengths):
    """The prefill of lanes split over dp (one lane a dp rank), joined."""
    per = tokens.shape[0] // len(groups)
    outs = [llm_prefill_kv(cfg, g, tokens[d * per:(d + 1) * per], lengths[d * per:(d + 1) * per])
            for d, g in enumerate(groups)]
    return torch.cat([o[0] for o in outs])


def test_mesh_shapes():
    mesh = make_mesh(_devices(8), tp=2)
    assert mesh.shape == {"dp": 4, "tp": 2} and mesh.axis_names == ("dp", "tp")
    assert mesh.devices.shape == (4, 2) and str(mesh.devices[1, 0]) == "cpu:2"
    mesh = make_mesh(_devices(8), tp=1)
    assert mesh.shape == {"dp": 8, "tp": 1}
    assert make_mesh().shape == {"dp": 8, "tp": 1}  # defaults: every device, tp 1
    with pytest.raises(ValueError, match=r"dp\*tp \(2\*2\) != n_devices \(3\)"):
        make_mesh(_devices(3), dp=2, tp=2)
    with pytest.raises(ValueError, match="twice"):
        make_mesh([_devices(1)[0]] * 2)
    # the JAX package's data specs: lanes over dp, kv heads over tp
    assert llm_data_shardings(mesh) == {"tokens": ("dp", None), "lengths": ("dp",),
                                        "cache": (None, "dp", None, "tp", None),
                                        "logits": ("dp", None)}
    assert codec_data_sharding(mesh) == ("dp", None)


def test_logical_devices(monkeypatch):
    """MIOTTS_LOGICAL_DEVICES=n presents the first device as n ranks; unset,
    the CPU is one rank."""
    devs = logical_devices("cpu")
    assert [str(d) for d in devs] == [f"cpu:{i}" for i in range(8)]
    assert {d.device for d in devs} == {CPU}
    monkeypatch.delenv(LOGICAL_ENV)
    assert [str(d) for d in logical_devices("cpu")] == ["cpu:0"]
    monkeypatch.setenv(LOGICAL_ENV, "0")
    with pytest.raises(ValueError):
        logical_devices("cpu")


def test_parse_backend_devices():
    devs = logical_devices("cpu")
    assert parse_backend_devices("") is None
    assert parse_backend_devices("  ") is None
    assert parse_backend_devices("all") == devs
    # a bare integer is an INDEX (same meaning with or without commas)
    assert parse_backend_devices("4") == [devs[4]]
    assert parse_backend_devices("0,2") == [devs[0], devs[2]]
    assert parse_backend_devices("CPU:1") == [devs[1]]
    with pytest.raises(ValueError, match="out of range"):
        parse_backend_devices("99")
    with pytest.raises(ValueError, match="unknown device"):
        parse_backend_devices("bogus:device")
    with pytest.raises(ValueError, match="named twice"):
        parse_backend_devices("1,cpu:1")


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_sharded_prefill_matches_single_device(llm, tp):
    cfg, w, _ = llm
    tokens, lengths = _prompts(0, 8, [8, 5])
    ck, cv = init_kv_cache(cfg, 2, 32, CPU, torch.float32)
    ref = llm_prefill(cfg, w, tokens, lengths, ck, cv)
    mesh = make_mesh(_devices(2 * tp), tp=tp)
    groups = shard_llm_weights(mesh, w, cfg)
    assert len(groups) == 2 and all(g.tp == tp for g in groups)
    per = []
    for d, g in enumerate(groups):
        ck, cv = init_kv_cache(cfg, 1, 32, CPU, torch.float32, w=g)
        assert isinstance(ck, tuple) and len(ck) == tp and ck[0].shape[3] == 8 // tp
        per.append(llm_prefill(cfg, g, tokens[d:d + 1], lengths[d:d + 1], ck, cv))
    np.testing.assert_allclose(torch.cat(per).numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def _generate(cfg, w, tokens, lengths, eog, n, sampler, B, S=48):
    ck, cv = init_kv_cache(cfg, B, S, CPU, torch.float32, w=w)
    return llm_generate(cfg, w, tokens, lengths, eog, sampler_key(0, CPU), n, sampler, ck, cv)


def test_tp_sharded_greedy_generation_matches(llm):
    cfg, w, tok = llm
    tokens, lengths = _prompts(1, 8, [8, 8])
    eog = torch.tensor([tok.eos_id], dtype=torch.int64)
    sampler = SamplerParams(temp=0.0)
    ref, ref_n = _generate(cfg, w, tokens, lengths, eog, 8, sampler, 2)
    groups = shard_llm_weights(make_mesh(_devices(8), tp=4), w, cfg)
    got = [_generate(cfg, g, tokens[d:d + 1], lengths[d:d + 1], eog, 8, sampler, 1)
           for d, g in enumerate(groups[:2])]
    np.testing.assert_array_equal(torch.cat([o for o, _ in got]).numpy(), ref.numpy())
    np.testing.assert_array_equal(torch.cat([n for _, n in got]).numpy(), ref_n.numpy())


@pytest.mark.parametrize("tp", [4, 8])
def test_tp_over_kv_heads(gqa_path, tp):
    """tp > n_kv_heads (2): each rank holds the one kv head its query heads
    read; prefill at 1e-5 and greedy tokens equal; the vocab (324) splits."""
    cfg, w, tok = load_llm_gguf(gqa_path, CPU, torch.float32)
    g = shard_llm_weights(make_mesh(_devices(tp), tp=tp), w, cfg)[0]
    assert g.embd_split == (324 % tp == 0) and g.head_split == g.embd_split
    assert g.cfgs[0].n_kv_heads == 1 and g.cfgs[0].n_heads == 8 // tp
    assert [kv_heads(cfg, tp, r) for r in range(tp)] == [[r * 2 // tp] for r in range(tp)]
    hd = cfg.head_dim
    for r, sh in enumerate(g.shards):
        kvh = r * 2 // tp
        Hd = cfg.n_heads * hd
        want = torch.cat([w["wqkv"][..., r * 8 // tp * hd:(r + 1) * 8 // tp * hd],
                          w["wqkv"][..., Hd + kvh * hd:Hd + (kvh + 1) * hd],
                          w["wqkv"][..., Hd + 2 * hd + kvh * hd:Hd + 2 * hd + (kvh + 1) * hd]],
                         dim=-1)
        assert torch.equal(sh["wqkv"], want)
    tokens, lengths = _prompts(2, 8, [8, 6])
    ref = llm_prefill_kv(cfg, w, tokens, lengths)[0]
    np.testing.assert_allclose(llm_prefill_kv(cfg, g, tokens, lengths)[0].numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5)
    eog = torch.tensor([tok.eos_id], dtype=torch.int64)
    sampler = SamplerParams(temp=0.0)
    a = _generate(cfg, w, tokens, lengths, eog, 8, sampler, 2)
    b = _generate(cfg, g, tokens, lengths, eog, 8, sampler, 2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_tp_decode_step_matches(gqa_path):
    """One decode step on the tp-split cache: logits at 1e-5, and each
    rank's cache part holds its kv heads of the single-device cache."""
    cfg, w, _ = load_llm_gguf(gqa_path, CPU, torch.float32)
    g = shard_llm_weights(make_mesh(_devices(2), tp=2), w, cfg)[0]
    tokens, lengths = _prompts(3, 8, [8, 5])
    ck, cv = init_kv_cache(cfg, 2, 16, CPU, torch.float32)
    gk, gv = init_kv_cache(cfg, 2, 16, CPU, torch.float32, w=g)
    llm_prefill(cfg, w, tokens, lengths, ck, cv)
    llm_prefill(cfg, g, tokens, lengths, gk, gv)
    tok, pos = torch.tensor([5, 9]), lengths.clone()
    a = llm_decode_step(cfg, w, tok, pos, ck, cv)
    b = llm_decode_step(cfg, g, tok, pos, gk, gv)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
    for r in range(2):
        np.testing.assert_allclose(gk[r].numpy(), ck[:, :, :, [r]].numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def llm_int8(llm_path):
    return load_llm_gguf(llm_path, CPU, torch.float32, quantize="int8")


def test_tp_sharded_int8_prefill_matches_single_device(llm_int8):
    """W8A8 leaves shard with Megatron's specs and reproduce the single-device
    int8 logits bit for bit (JAX holds its to 1e-4): the row-parallel
    activations are quantized with the whole rows' scales (the group's max)
    and the ranks' int32 dots summed exactly before the scales."""
    cfg, w, _ = llm_int8
    tokens, lengths = _prompts(1, 8, [8, 6])
    ck, cv = init_kv_cache(cfg, 2, 32, CPU, torch.float32)
    ref = llm_prefill(cfg, w, tokens, lengths, ck, cv)
    mesh = make_mesh(_devices(4), tp=2)
    specs = llm_weight_shardings(mesh, w)
    assert specs["wqkv"]["q8"] == (None, None, "tp") and specs["wqkv"]["s8"] == (None, "tp")
    assert specs["wo"]["q8"] == (None, "tp", None) and specs["wo"]["s8"] == (None, None)
    groups = shard_llm_weights(mesh, w, cfg)
    sh = groups[0].shards[1]
    assert sh["wo"]["q8"].shape[1] == w["wo"]["q8"].shape[1] // 2
    assert torch.equal(sh["wo"]["s8"], w["wo"]["s8"])  # per-column scales stay whole
    got = _dp_prefill(cfg, groups, tokens, lengths)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
    assert torch.equal(got, ref)


def test_tp_sharded_int8_generation_runs(llm_int8):
    cfg, w, _ = llm_int8
    g = shard_llm_weights(make_mesh(_devices(2), tp=2), w, cfg)[0]
    tokens, lengths = _prompts(2, 6, [6, 6])
    out, n = _generate(cfg, g, tokens, lengths, torch.tensor([-1]), 8, SamplerParams(temp=0.8),
                       2, S=32)
    assert n.tolist() == [8, 8] and (out >= 0).all()


def test_q8_0_shard_rules(llm_path):
    """A Q8_0 shard that K3 cannot take is refused by name: at tp 4 the
    8-head model's wo rows are 16 a rank, not a multiple of 32."""
    cfg, w, _ = load_llm_gguf(llm_path, CPU, torch.float32, quantize="q8_0")
    shard_llm_weights(make_mesh(_devices(2), tp=2), w, cfg)
    with pytest.raises(ValueError, match="wo shard .* K3's rule K % 32"):
        shard_llm_weights(make_mesh(_devices(4), tp=4), w, cfg)
    with pytest.raises(ValueError, match="into whole heads"):
        shard_llm_weights(make_mesh(_devices(3), tp=3), w, cfg)


def test_fused_and_unfused_leaves_agree(gqa_path, monkeypatch):
    """MIOTTS_LLM_FUSE=0 keeps one leaf a projection; its logits and greedy
    tokens are the fused layout's, on one device and over tp."""
    cfg, wf, tok = load_llm_gguf(gqa_path, CPU, torch.float32)
    monkeypatch.setenv("MIOTTS_LLM_FUSE", "0")
    _, wu, _ = load_llm_gguf(gqa_path, CPU, torch.float32)
    assert "wqkv" not in wu and {"wq", "wk", "wv", "w_gate", "w_up"} <= set(wu)
    tokens, lengths = _prompts(4, 8, [8, 3])
    a = llm_prefill_kv(cfg, wf, tokens, lengths)[0]
    b = llm_prefill_kv(cfg, wu, tokens, lengths)[0]
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)
    g = shard_llm_weights(make_mesh(_devices(4), tp=4), wu, cfg)[0]
    np.testing.assert_allclose(llm_prefill_kv(cfg, g, tokens, lengths)[0].numpy(), a.numpy(),
                               rtol=1e-5, atol=1e-5)
    eog = torch.tensor([tok.eos_id], dtype=torch.int64)
    ta = _generate(cfg, wf, tokens, lengths, eog, 8, SamplerParams(temp=0.0), 2)
    tb = _generate(cfg, g, tokens, lengths, eog, 8, SamplerParams(temp=0.0), 2)
    assert torch.equal(ta[0], tb[0])


@pytest.mark.parametrize("quant", [None, "q8_0"])
def test_unfused_leaves_packed_route(gqa_path, monkeypatch, quant):
    """Under MIOTTS_LLM_FUSE=0 the packed route (runtime/device_dequant.py)
    builds the per-projection leaves bit for bit as the per-leaf route."""
    monkeypatch.setenv("MIOTTS_LLM_FUSE", "0")
    monkeypatch.setenv("MIOTTS_DEVICE_DEQUANT", "0")
    _, a, _ = load_llm_gguf(gqa_path, CPU, quantize=quant)
    monkeypatch.setenv("MIOTTS_DEVICE_DEQUANT", "1")
    _, b, _ = load_llm_gguf(gqa_path, CPU, quantize=quant)
    assert a.keys() == b.keys() and "wk" in a and "w_up" in a
    for k, v in a.items():
        for sub, t in (v.items() if isinstance(v, dict) else [(None, v)] if v is not None else []):
            other = b[k][sub] if sub is not None else b[k]
            assert t.dtype == other.dtype and torch.equal(t, other), (k, sub)


def test_state_spread_over_ranks(gqa_path):
    """``shard_gen_state``: lanes in contiguous blocks over dp, each dp
    rank's cache a tuple of its tp ranks' kv heads; the keys stay the
    global state's."""
    cfg, w, _ = load_llm_gguf(gqa_path, CPU, torch.float32)
    mesh = make_mesh(_devices(8), tp=4)
    groups = shard_llm_weights(mesh, w, cfg)
    st = init_batched_state(cfg, 4, 16, CPU, seed=3)
    st.cache_k.normal_()
    parts = shard_gen_state(mesh, st, groups)
    assert gen_state_shardings(mesh)["cache_k"] == (None, "dp", None, "tp", None)
    assert len(parts) == 2 and all(isinstance(p, GenState) for p in parts)
    for d, p in enumerate(parts):
        assert torch.equal(p.key, st.key[2 * d:2 * d + 2]) and p.pos.shape == (2,)
        assert len(p.cache_k) == 4
        for r, part in enumerate(p.cache_k):
            assert torch.equal(part, st.cache_k[:, 2 * d:2 * d + 2, :, kv_heads(cfg, 4, r)])
            assert part.is_contiguous() and part.data_ptr() != st.cache_k.data_ptr()
    trees = replicate_tree(mesh, {"a": st.pos})
    assert len(trees) == 8 and all(t["a"] is st.pos for t in trees)  # one device: no copies


def test_collectives():
    a, b = torch.tensor([1.0, -2.0]), torch.tensor([3.0, 5.0])
    assert torch.equal(collectives.tp_sum([a, b], CPU, torch.float32), a + b)
    assert torch.equal(collectives.tp_max([a, b], CPU), torch.tensor([3.0, 5.0]))
    assert torch.equal(collectives.gather_vocab([a[None], b[None]], CPU),
                       torch.tensor([[1.0, -2.0, 3.0, 5.0]]))


# ---------------------------------------------------------------------------
# against the JAX package's shards and sharded prefill
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def aligned_path(tmp_path_factory):
    """Projections whose 128-padded quantized widths split on head bounds at
    tp 2 (heads of 64: q 256, k/v 128, ffn 512), an even vocab."""
    path = tmp_path_factory.mktemp("tjax") / "llm.gguf"
    write_synthetic_llm_gguf(str(path), n_audio=64, dim=256, n_layers=2, n_heads=4,
                             n_kv_heads=2, ffn=512, seed=5, n_filler_vocab=1)
    return str(path)


def _jax_rank_leaf(arr, mesh, r):
    dev = mesh.devices[0, r]
    return np.asarray(next(s.data for s in arr.addressable_shards if s.device == dev))


@pytest.mark.parametrize("quant", [None, "q8_0", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_rank_leaves_match_jax_shards(aligned_path, monkeypatch, quant, tp):
    """Under MIOTTS_LLM_FUSE=0 each rank's leaf is the matching addressable
    shard of JAX's ``shard_llm_weights`` (JAX and the port load the same
    leaves, tests/test_torch_llm.py); at tp 4 > 2 kv heads JAX splits a kv
    head across two ranks, so the port's whole-head k/v leaves are held to
    that head's columns of JAX's leaf instead."""
    monkeypatch.setenv("MIOTTS_LLM_FUSE", "0")
    monkeypatch.setenv("MIOTTS_OUTPUT_LAYOUT", "token")
    jcfg, jw, _ = jllm.load_llm_gguf(aligned_path, dtype=jnp.float32, quantize=quant)
    cfg, w, _ = load_llm_gguf(aligned_path, CPU, torch.float32, quantize=quant)
    jm = jmesh.make_mesh(jax.devices()[:tp], tp=tp)
    jws = jmesh.shard_llm_weights(jm, jw)
    g = shard_llm_weights(make_mesh(_devices(tp), tp=tp), w, cfg)[0]
    hd = cfg.head_dim
    checked = 0
    for name in ("token_embd", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "output"):
        for r, sh in enumerate(g.shards):
            mine = sh[name]
            for sub in (mine if isinstance(mine, dict) else {None: mine}):
                got = (mine[sub] if sub is not None else mine).numpy()
                full = jws[name][sub] if sub is not None else jws[name]
                if name in ("wk", "wv") and tp > cfg.n_kv_heads:
                    kvh = kv_heads(cfg, tp, r)[0]
                    want = np.asarray(full)[..., kvh * hd:(kvh + 1) * hd]
                else:
                    want = _jax_rank_leaf(full, jm, r)
                np.testing.assert_array_equal(got, want, err_msg=f"{name}.{sub} rank {r}")
                checked += 1
    assert checked >= 9 * tp


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_prefill_logits_match_jax(llm_path, gqa_path, tp):
    """The port's tp prefill against JAX's sharded ``llm_prefill`` on the
    same weights and mesh shape (dp 2), f32: atol 1e-4; the GQA model (2 kv
    heads) at tp 2 only, as JAX's cache sharding splits whole kv heads."""
    for path in (llm_path, gqa_path)[:3 - tp // 2]:
        jcfg, jw, _ = jllm.load_llm_gguf(path, dtype=jnp.float32)
        cfg, w, _ = load_llm_gguf(path, CPU, torch.float32)
        tokens, lengths = _prompts(0, 8, [8, 5])
        jm = jmesh.make_mesh(jax.devices()[:2 * tp], tp=tp)
        with jm:
            jws = jmesh.shard_llm_weights(jm, jw)
            data = jmesh.llm_data_shardings(jm)
            ck, cv = jllm.init_kv_cache(jcfg, 2, 32, dtype=jnp.float32)
            ref, _, _ = jax.jit(jllm.llm_prefill, static_argnums=0)(
                jcfg, jws, jax.device_put(tokens.numpy().astype(np.int32), data["tokens"]),
                jax.device_put(lengths.numpy(), data["lengths"]),
                jax.device_put(np.asarray(ck), data["cache"]),
                jax.device_put(np.asarray(cv), data["cache"]))
        groups = shard_llm_weights(make_mesh(_devices(2 * tp), tp=tp), w, cfg)
        assert isinstance(groups[1], TPGroup)
        got = _dp_prefill(cfg, groups, tokens, lengths)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_logical_env_is_the_port_knob():
    """The knob is the port's own name, read at call time."""
    assert LOGICAL_ENV == "MIOTTS_LOGICAL_DEVICES" and os.environ[LOGICAL_ENV] == "8"
