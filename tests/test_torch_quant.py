"""The port's quantized LLM path (``--llm-quant``) against the JAX package,
on the tiny GGUF of tests/test_quant.py (dim 32, 2 layers, GQA 4/2, so the
quantized leaves pad N from 32 to 128), stored both as f32 and as Q8_0.

Tolerances and why:

- The host quantizers and the loaders' leaves are bit-equal (same numpy).
- ``q8_matmul_plain`` against JAX's Pallas ``q8_matmul`` in interpret mode:
  both sum the same exact bf16 x bf16 products in f32, in another order, so
  each output may differ by at most 2 * K * 2^-24 * sum_k |x_k w_k|.
- W8A8 and W4A8 products are exact integer dots on both sides, then the
  same f32 scalings: equal to the bit.
- Whole-model logits at bf16: the dense and Q8_0 layer modes stay within
  0.12 of JAX (as the dense bf16 model does, tests/test_torch_llm.py: bf16
  activations round differently in silu, RoPE and attention); modes with
  W8A8 layers within 0.3, because an activation one bf16 ulp apart can move
  its int8 code by one step (1/127 of its row's max).
- At f32 activations the exact-integer modes agree to 1e-4 and give the
  same 16 greedy tokens. The Q8_0 modes are held at bf16 only: the port
  follows the TPU kernel, which rounds x and the weights to bf16, where
  JAX's CPU fallback multiplies in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu.models import llm as jllm
from miotts_tpu.models import sampling as jsampling
from miotts_tpu.ops.pallas import quant_matmul as jqm
from miotts_tpu_torch.convert import llm_params_from_jax
from miotts_tpu_torch.models import llm as tllm
from miotts_tpu_torch.models.sampling import SamplerParams
from miotts_tpu_torch.ops import quant_matmul as tqm
from miotts_tpu_torch.ops.cuda import q8_matmul as k3
from miotts_tpu_torch.testing import write_synthetic_llm_gguf

torch.set_num_threads(1)
CPU = torch.device("cpu")

# every value the JAX loader accepts, with its aliases, and one it does not
ALL_MODES = ["", "bf16", "none", "off", "output", "all", "q8", "q8_0", "1", True, "int8",
             "w8a8", "output_int8", "output-int8", "output_int4", "output-int4",
             "int8_output_int4", "int8+output_int4", "bogus"]
# the --llm-quant choices of the CLI
CLI_MODES = ["bf16", "output", "q8_0", "int8", "output_int8", "output_int4", "int8_output_int4"]
EXACT_MODES = ["bf16", "int8", "output_int8", "output_int4", "int8_output_int4"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("qllm")
    paths = {}
    for storage in ("f32", "q8_0"):
        paths[storage] = str(d / f"llm_{storage}.gguf")
        write_synthetic_llm_gguf(paths[storage], n_audio=64, dim=32, n_layers=2, n_heads=4,
                                 n_kv_heads=2, ffn=64, seed=0, quant=storage)
    return paths


def _bf16_np(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _sum_order_bound(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Worst-case gap of two f32 sums of the same K exact products."""
    return 2 * x.shape[1] * 2.0 ** -24 * (np.abs(x) @ np.abs(w)) + 1e-30


def _weights_with_ties() -> np.ndarray:
    """[K=64, N=160] with random columns, a zero column, and columns whose
    quantization lands exactly on .5: round half to even must match."""
    rng = np.random.RandomState(5)
    w = (rng.randn(64, 160) * 0.3).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = np.resize(np.arange(-10, 10) + 0.5, 64)  # Q8_0 scale 1 per block
    w[::32, 1] = 127.0
    w[:, 2] = np.resize(np.arange(-6, 6) * 0.5 + 0.25, 64)  # int8 per-column scale 1/2
    w[0, 2] = 63.5
    w[:, 3] = np.resize([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], 64)  # int4 scale 1
    w[0, 3] = 7.0
    return w


@pytest.mark.parametrize("name", ["quantize_q8_cols", "quantize_int8_percol",
                                  "quantize_int4_percol"])
def test_quantizers_bit_equal_jax(name):
    w = _weights_with_ties()
    got, ref = getattr(tqm, name)(w), getattr(jqm, name)(w)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("T", [1, 3, 16])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_q8_matmul_plain_matches_jax_interpret(T, dtype):
    rng = np.random.RandomState(T)
    K, N = 256, 384
    q, s = jqm.quantize_q8_cols((rng.randn(K, N) * 0.1).astype(np.float32))
    x = (rng.randn(T, K) * 0.5).astype(np.float32)
    ref = np.asarray(jqm.q8_matmul(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(q),
                                   jnp.asarray(s), block_k=256, block_n=128, interpret=True))
    got = k3.q8_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(q),
                       torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (T, N)
    w = _bf16_np(q.astype(np.float32) * np.repeat(s, 32, axis=0))
    assert (np.abs(got.numpy() - ref) <= _sum_order_bound(_bf16_np(x), w)).all()


def test_dequant_dense_matches_jax():
    """Layer-stacked [L, K, N] leaves expand per layer as JAX's [K, N] one."""
    rng = np.random.RandomState(8)
    leaves = [jqm.quantize_q8_cols((rng.randn(64, 128) * 0.2).astype(np.float32))
              for _ in range(2)]
    got = tqm.dequant_dense({"q": torch.from_numpy(np.stack([q for q, _ in leaves])),
                             "s": torch.from_numpy(np.stack([s for _, s in leaves]))})
    for li, (q, s) in enumerate(leaves):
        ref = np.asarray(jqm.dequant_dense({"q": jnp.asarray(q), "s": jnp.asarray(s)}))
        np.testing.assert_array_equal(got[li].numpy(), ref)


def _leaf(kind: str, w: np.ndarray) -> dict:
    if kind == "q4":  # the in-graph converted W4A8 form: int4 in JAX, int8 here
        q4, s4 = jqm.quantize_int4_percol(w)
        return {"q4": q4, "s4": s4}
    return tllm.quantize_kn(w, kind)


@pytest.mark.parametrize("kind,dtype", [
    ("q8_0", "bfloat16"), ("int8", "float32"), ("int8", "bfloat16"), ("int4", "float32"),
    ("int4", "bfloat16"), ("q4", "float32")])
def test_maybe_quant_matmul_matches_jax(kind, dtype):
    rng = np.random.RandomState(7)
    wkn = (rng.randn(64, 96) * 0.2).astype(np.float32)
    leaf = _leaf(kind, wkn)
    x = (rng.randn(2, 3, 64) * 0.7).astype(np.float32)
    jleaf = {k: jnp.asarray(v).astype(jnp.int4) if k == "q4" else jnp.asarray(v)
             for k, v in leaf.items()}
    ref = np.asarray(jqm.maybe_quant_matmul(jnp.asarray(x, getattr(jnp, dtype)), jleaf),
                     np.float32)
    got = tqm.maybe_quant_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                                 {k: torch.from_numpy(v) for k, v in leaf.items()})
    n = leaf["s4" if "s4" in leaf else "s8" if "s8" in leaf else "s"].shape[-1]
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 3, n)
    got = got.float().numpy()
    if kind != "q8_0":
        np.testing.assert_array_equal(got, ref)  # exact integer dots, same f32 scaling
        return
    # JAX's CPU fallback and the plain K3 sum the same bf16 products in f32,
    # then round to bf16: at most one bf16 ulp apart
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)


def _same_leaves(port: dict, jax_tree: dict, token_major: bool) -> None:
    for k, v in port.items():
        ref = jax_tree.get(k)
        if v is None or ref is None:
            assert v is None and ref is None, k
        elif isinstance(v, dict):
            assert isinstance(ref, dict) and set(v) == set(ref), k
            for sk, a in v.items():
                r = np.asarray(ref[sk])
                assert a.numpy().dtype == r.dtype, (k, sk)
                np.testing.assert_array_equal(a.numpy(), r)
        else:
            r = np.asarray(ref, np.float32)
            if k == "output" and not token_major:
                r = r.T
            np.testing.assert_array_equal(v.float().numpy(), r)


@pytest.mark.parametrize("storage", ["f32", "q8_0"])
@pytest.mark.parametrize("mode", ALL_MODES)
def test_loader_leaves_match_jax(tiny, storage, mode, capsys):
    def warnings():
        return [ln for ln in capsys.readouterr().err.splitlines() if "warning:" in ln]

    jcfg, jw, _ = jllm.load_llm_gguf(tiny[storage], dtype=jnp.float32, quantize=mode)
    jwarn = warnings()
    cfg, w, _ = tllm.load_llm_gguf(tiny[storage], CPU, torch.float32, quantize=mode)
    assert warnings() == jwarn and bool(jwarn) == (mode == "bogus")  # word for word
    jnp_tree = jax.tree.map(np.asarray, jw)
    _same_leaves(w, jnp_tree, jcfg.output_token_major)
    # the same leaves arrive through the converter
    _, w2 = llm_params_from_jax(jcfg, jnp_tree, CPU, torch.float32)
    _same_leaves(w2, jnp_tree, jcfg.output_token_major)


def test_tied_head_quant_warns_as_jax(capsys):
    for requested, mode in ((True, "output_int4"), (False, "")):
        assert jllm._warn_tied_quant_noop(requested, mode) is None
        ref = capsys.readouterr().err
        assert tllm._warn_tied_quant_noop(requested, mode) is None
        assert capsys.readouterr().err == ref
        assert ("cannot quantize" in ref) == requested


def _prompts():
    rng = np.random.RandomState(0)
    return rng.randint(0, 300, (2, 12)).astype(np.int32), np.array([12, 7], np.int32)


def _prefill_and_decode(path, mode, jdtype, tdtype):
    """(port, JAX) logits of a prefill and three decode steps, ragged pos."""
    jcfg, jw, _ = jllm.load_llm_gguf(path, dtype=jdtype, quantize=mode)
    cfg, w, _ = tllm.load_llm_gguf(path, CPU, tdtype, quantize=mode)
    toks, lens = _prompts()
    jck, jcv = jllm.init_kv_cache(jcfg, 2, 24)
    jlog, jck, jcv = jllm.llm_prefill(jcfg, jw, jnp.asarray(toks), jnp.asarray(lens), jck, jcv)
    ck, cv = tllm.init_kv_cache(cfg, 2, 24, CPU)
    log = tllm.llm_prefill(cfg, w, torch.from_numpy(toks), torch.from_numpy(lens), ck, cv)
    out = [(log.numpy(), np.asarray(jlog, np.float32))]
    pos = lens.copy()
    for step in range(3):
        tok = np.array([5 + step, 70 + step], np.int32)
        jlog, jck, jcv = jllm.llm_decode_step(jcfg, jw, jnp.asarray(tok), jnp.asarray(pos),
                                              jck, jcv)
        log = tllm.llm_decode_step(cfg, w, torch.from_numpy(tok), torch.from_numpy(pos), ck, cv)
        assert log.dtype == torch.float32 and log.shape == (2, cfg.vocab_size)
        out.append((log.numpy(), np.asarray(jlog, np.float32)))
        pos += 1
    return out


@pytest.mark.parametrize("mode", CLI_MODES)
def test_logits_match_jax_bf16(tiny, mode):
    atol = 0.3 if mode.startswith("int8") else 0.12
    for got, ref in _prefill_and_decode(tiny["q8_0"], mode, jnp.bfloat16, torch.bfloat16):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("mode", EXACT_MODES)
def test_logits_match_jax_f32_exact_modes(tiny, mode):
    for got, ref in _prefill_and_decode(tiny["f32"], mode, jnp.float32, torch.float32):
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", EXACT_MODES)
def test_greedy_tokens_match_jax_f32(tiny, mode):
    jeng = jllm.LLMEngine(tiny["f32"], dtype=jnp.float32, quantize=mode)
    eng = tllm.LLMEngine(tiny["f32"], CPU, dtype=torch.float32, quantize=mode)
    assert eng.quantize == jeng.quantize == mode
    for text in ("hello there", "a longer prompt, with punctuation!"):
        ref = jeng.generate_audio_tokens(text, n_predict=16,
                                         sampler=jsampling.SamplerParams(temp=0.0))
        got = eng.generate_audio_tokens(text, n_predict=16, sampler=SamplerParams(temp=0.0))
        assert got == ref


def test_engine_defers_to_env(tiny, monkeypatch):
    monkeypatch.setenv("MIOTTS_LLM_QUANT", "q8_0")
    eng = tllm.LLMEngine(tiny["q8_0"], CPU)
    assert eng.quantize == "q8_0"
    assert all(set(eng.weights[k]) == {"q", "s"}
               for k in ("wqkv", "wo", "w_gateup", "w_down", "output"))
    monkeypatch.setenv("MIOTTS_LLM_QUANT", "")
    eng = tllm.LLMEngine(tiny["q8_0"], CPU, quantize="output")
    assert eng.quantize == "output" and isinstance(eng.weights["output"], dict)
    assert not isinstance(eng.weights["wqkv"], dict)
    assert tllm.LLMEngine(tiny["q8_0"], CPU).quantize == "bf16"


def test_dense_head_writes_f32_sums():
    """The dense bf16 head accumulates into f32 (the ROADMAP fault it had
    rounded its logits to bf16): it equals the f32 product of the bf16
    values, as JAX's preferred_element_type=f32 dot does."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 32).astype(np.float32)).to(torch.bfloat16)
    head = torch.from_numpy(rng.randn(300, 32).astype(np.float32)).to(torch.bfloat16)
    got = tllm._dense_logits(x, head)
    assert got.dtype == torch.float32
    ref = np.asarray(jax.lax.dot_general(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(head.float().numpy(),
                                                                  jnp.bfloat16),
        (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    # bf16 output would be off by up to half an ulp: ~8e-3 at |logit| ~ 2
    assert np.abs(got.numpy() - (x @ head.t()).float().numpy()).max() > 1e-4


def test_cpu_tensors_never_launch_k3(tiny):
    k3.launches = 0
    cfg, w, _ = tllm.load_llm_gguf(tiny["q8_0"], CPU, torch.bfloat16, quantize="q8_0")
    toks, lens = _prompts()
    tllm.llm_prefill_kv(cfg, w, torch.from_numpy(toks), torch.from_numpy(lens))
    assert k3.launches == 0


def test_k3_wrapper_refuses_other_devices():
    x = torch.empty(2, 64, dtype=torch.bfloat16, device="meta")
    q = torch.empty(64, 128, dtype=torch.int8, device="meta")
    s = torch.empty(2, 128, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k3.q8_matmul(x, q, s)
    assert k3.launches == 0


@pytest.mark.parametrize("T,K,N", [
    (1, 768, 1024), (1, 768, 768), (1, 768, 4096), (1, 2048, 768), (1, 768, 151808),
    (8, 2048, 768), (64, 768, 4096), (512, 2048, 768), (3, 32, 4), (5, 8192, 8)])
def test_k3_launch_shape(T, K, N):
    """The wrapper's launch plan: a row tile in {1, 2, 4, 8} that covers T
    up to 8, K splits that are all non-empty, and an x tile that fits the
    shared-memory budget the kernel is launched with."""
    tt, z = k3.launch_shape(T, K, N)
    nkb = K // k3.QBLOCK
    assert tt in (1, 2, 4, 8) and (tt >= T or tt == 8)
    per = -(-nkb // z)
    assert 1 <= z <= nkb and (z - 1) * per < nkb
    assert tt * per * k3.QBLOCK * 4 <= k3._SMEM_TILE
