"""The port's native int8/int4 CPU LLM engine (miotts_tpu_torch.models.llm_cpu)
and its C++ GEMVs (miotts_tpu_torch.runtime.native) against the JAX package's.

Both packages build the same C++ with the same flags, so the port's
``Q8Gemv``/``Q4Gemv`` and row dequant equal JAX's bit for bit, and the two
engines (numpy around the same kernels, numpy's ``default_rng(seed)`` for
the sampler) give the same logits and the same tokens, greedy and sampled.
The two libraries live in one process: ctypes loads each with RTLD_LOCAL.
Also the CLI's engine choice (``cli._make_llm_engine``) and its
MIOTTS_CPU_NATIVE default. Skipped only where no C++ compiler can build
the library."""

import concurrent.futures
import types

import numpy as np
import pytest
import torch

from miotts_tpu.models.llm_cpu import NativeCpuLLMEngine as JaxEngine
from miotts_tpu.models.sampling import SamplerParams as JaxSampler
from miotts_tpu.runtime import native as jax_native
from miotts_tpu_torch import cli
from miotts_tpu_torch.models import llm as llm_mod
from miotts_tpu_torch.models import llm_cpu
from miotts_tpu_torch.models.llm import LLMEngine
from miotts_tpu_torch.models.llm_cpu import NativeCpuLLMEngine
from miotts_tpu_torch.models.sampling import SamplerParams
from miotts_tpu_torch.runtime import build_native, native
from miotts_tpu_torch.testing import write_synthetic_llm_gguf

torch.set_num_threads(1)
pytestmark = pytest.mark.skipif(build_native.compiler() is None,
                                reason="no C++ compiler (g++ or clang++) to build the native library")

SAMPLED = dict(temp=0.8, top_k=40, top_p=0.9, repeat_penalty=1.1, seed=11)


def _q8_oracle(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """tests/test_llm_cpu.py's block-quantized reference: both sides
    quantized per 32-block as the kernel does, f16 weight scales."""
    n, k = w.shape
    bw = w.reshape(n, k // 32, 32)
    dw = np.abs(bw).max(2) / 127.0
    qw = np.rint(bw / np.where(dw == 0, 1, dw)[:, :, None]).astype(np.int8)
    bx = x.reshape(k // 32, 32)
    dx = (np.abs(bx).max(1) / 127.0).astype(np.float32)
    inv = np.where(dx > 0, 1.0 / np.where(dx == 0, 1, dx), 0.0)
    qx = np.rint(bx * inv[:, None]).astype(np.int8)
    dots = (qw.astype(np.int32) * qx.astype(np.int32)[None]).sum(2)
    scales = dw.astype(np.float16).astype(np.float32) * dx
    return (dots * scales).sum(1).astype(np.float32)


def _q4_oracle(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Weights through the port's Q4_0 dequant, activations per 32-block."""
    from miotts_tpu_torch.gguf.quants import GGMLType, dequantize

    n, k = w.shape
    wd = dequantize(native.q4_quantize_weights(w), GGMLType.Q4_0, n * k).reshape(n, k)
    bx = x.reshape(k // 32, 32)
    dx = (np.abs(bx).max(1) / 127.0).astype(np.float32)
    inv = np.where(dx > 0, 1.0 / np.where(dx == 0, 1, dx), 0.0)
    qx = np.rint(bx * inv[:, None]).astype(np.int8)
    return (wd @ (qx * dx[:, None]).reshape(k)).astype(np.float32)


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
@pytest.mark.parametrize("n,k,B", [(64, 64, 3), (33, 96, 5), (768, 2048, 4)])
def test_gemv_gemm_match_jax(kind, n, k, B):
    """__call__ and gemm at 1 and 4 threads: bit-equal to JAX's bindings on
    the same bytes, and to the numpy oracle within its rounding."""
    rng = np.random.RandomState(n + k)
    w = rng.randn(n, k).astype(np.float32)
    x = rng.randn(k).astype(np.float32)
    X = rng.randn(B, k).astype(np.float32)
    if kind == "q8_0":
        raw = native.q8_quantize_weights(w)
        assert np.array_equal(raw, jax_native.q8_quantize_weights(w))
        port, ref = native.Q8Gemv(raw, n, k), jax_native.Q8Gemv(raw, n, k)
        np.testing.assert_allclose(port(x), _q8_oracle(w, x), rtol=1e-5, atol=1e-4)
    else:
        raw = native.q4_quantize_weights(w)
        assert np.array_equal(raw, jax_native.q4_quantize_weights(w))
        port, ref = native.Q4Gemv(raw, n, k), jax_native.Q4Gemv(raw, n, k)
        np.testing.assert_allclose(port(x), _q4_oracle(w, x), rtol=1e-4, atol=2e-3)
    for nt in (1, 4):
        np.testing.assert_array_equal(port(x, n_threads=nt), ref(x, n_threads=nt))
        np.testing.assert_array_equal(port.gemm(X, n_threads=nt), ref.gemm(X, n_threads=nt))
    np.testing.assert_array_equal(port.gemm(X), np.stack([port(X[b]) for b in range(B)]))


@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
def test_row_dequant_matches_jax(kind):
    w = np.random.RandomState(3).randn(9, 128).astype(np.float32)
    quant = native.q8_quantize_weights if kind == "q8_0" else native.q4_quantize_weights
    port = native.q8_row_dequant if kind == "q8_0" else native.q4_row_dequant
    ref = jax_native.q8_row_dequant if kind == "q8_0" else jax_native.q4_row_dequant
    raw = quant(w)
    for row in (0, 4, 8):
        np.testing.assert_array_equal(port(raw, row, 128), ref(raw, row, 128))


def test_two_libraries_in_one_process():
    """The port's library is its own file, loaded RTLD_LOCAL beside JAX's."""
    assert native.q8_available() and jax_native.q8_available()
    assert native._load()._name != jax_native._load()._name
    assert native._load().mio_runtime_abi_version() == 6  # JAX's library version (mp3 too)


@pytest.fixture(scope="module", params=["q8_0", "q4_0"])
def engine_pair(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("llmcpu") / f"llm_{request.param}.gguf"
    write_synthetic_llm_gguf(str(path), n_audio=128, seed=1, audio_logit_scale=3.0,
                             quant=request.param)
    return request.param, NativeCpuLLMEngine(str(path)), JaxEngine(str(path))


def test_engine_tokens_match_jax(engine_pair):
    """Greedy and sampled tokens identical to the JAX engine's."""
    kind, port, ref = engine_pair
    assert port.quantize == ref.quantize == f"{kind}-cpu"
    for kw in (dict(temp=0.0, top_k=50, seed=3), SAMPLED):
        got = port.generate_audio_tokens("Hello world", n_predict=24, sampler=SamplerParams(**kw))
        want = ref.generate_audio_tokens("Hello world", n_predict=24, sampler=JaxSampler(**kw))
        assert got and got == want, kw
    assert port.tokens_to_codes(got) == ref.tokens_to_codes(want)


def test_step_logits_match_jax(engine_pair):
    """_step's and blocked prefill's logits and caches equal JAX's."""
    _, port, ref = engine_pair
    ids = np.random.RandomState(5).randint(0, port.vocab_size, 19).tolist()
    caches = []
    for eng in (port, ref):
        kc = np.zeros((eng.n_layers, 24, eng.n_kv, eng.head_dim), np.float32)
        vc = np.zeros_like(kc)
        logits = eng._prefill(ids, kc, vc)
        caches.append((logits, eng._step(7, len(ids), kc, vc), kc, vc))
    for a, b in zip(*caches):
        np.testing.assert_array_equal(a, b)


def test_streaming_matches_jax(engine_pair):
    """The streaming API with ``chunk=`` and a cancel after 8 tokens."""
    _, port, ref = engine_pair
    seen = {}
    for name, eng, sp in (("port", port, SamplerParams(**SAMPLED)),
                          ("jax", ref, JaxSampler(**SAMPLED))):
        seen[name] = []
        out = eng.generate_audio_tokens_streaming(
            "stream me", lambda t, i, e, s=seen[name]: s.append(t) or i < 7, n_predict=16,
            sampler=sp, chunk=16)
        assert out == seen[name] and len(out) == 8
    assert seen["port"] == seen["jax"]


def test_greedy_matches_torch_engine(tmp_path):
    """temp 0 on a tiny f32 GGUF: the native engine's tokens equal the
    port's torch LLMEngine's (as tests/test_llm_cpu.py:68-79 holds JAX's
    engines); Q8_0 noise does not flip the argmax chain here."""
    path = tmp_path / "llm.gguf"
    write_synthetic_llm_gguf(str(path), n_audio=128, seed=1)
    sp = SamplerParams(temp=0.0, top_k=50, seed=3)
    got = NativeCpuLLMEngine(str(path)).generate_audio_tokens("Hello world", n_predict=24,
                                                              sampler=sp)
    want = LLMEngine(str(path), torch.device("cpu")).generate_audio_tokens(
        "Hello world", n_predict=24, sampler=sp)
    assert got == want


def test_cpu_quant_force_q4(tmp_path, monkeypatch):
    """MIOTTS_CPU_QUANT=q4_0 requantizes an f32 GGUF to Q4_0 as JAX's does:
    the same tokens; a bad value raises."""
    path = tmp_path / "llm_f32.gguf"
    write_synthetic_llm_gguf(str(path), n_audio=96, seed=5)
    monkeypatch.setenv("MIOTTS_CPU_QUANT", "q4_0")
    port, ref = NativeCpuLLMEngine(str(path)), JaxEngine(str(path))
    assert port.quantize == "q4_0-cpu"
    got = port.generate_audio_tokens("force q4", n_predict=12,
                                     sampler=SamplerParams(temp=0.8, top_k=40, seed=9))
    assert got == ref.generate_audio_tokens("force q4", n_predict=12,
                                            sampler=JaxSampler(temp=0.8, top_k=40, seed=9))
    monkeypatch.setenv("MIOTTS_CPU_QUANT", "q2_k")
    with pytest.raises(ValueError):
        NativeCpuLLMEngine(str(path))


def test_blocked_prefill_matches_sequential_step(engine_pair):
    """_prefill (a GEMM a block of 16 prompt tokens) reproduces the
    token-by-token _step chain."""
    _, port, _ = engine_pair
    ids = np.random.RandomState(3).randint(0, port.vocab_size, 21).tolist()  # 16 + 5
    S = len(ids) + 4
    kc1 = np.zeros((port.n_layers, S, port.n_kv, port.head_dim), np.float32)
    vc1, kc2, vc2 = np.zeros_like(kc1), np.zeros_like(kc1), np.zeros_like(kc1)
    for pos, tok in enumerate(ids):
        logits_seq = port._step(int(tok), pos, kc1, vc1)
    logits_blk = port._prefill(ids, kc2, vc2)
    np.testing.assert_allclose(logits_blk, logits_seq, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(kc2, kc1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vc2, vc1, rtol=1e-5, atol=1e-6)


def test_two_threads_on_one_engine(engine_pair):
    """Two threads generating on one engine get what single runs get."""
    _, port, _ = engine_pair
    prompts = ["thread one says", "thread two answers"]
    sp = [SamplerParams(temp=0.8, top_k=40, seed=21), SamplerParams(temp=0.8, top_k=40, seed=22)]
    expect = [port.generate_audio_tokens(p, n_predict=12, sampler=s) for p, s in zip(prompts, sp)]
    for _ in range(3):
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            got = list(ex.map(lambda a: port.generate_audio_tokens(a[0], n_predict=12,
                                                                   sampler=a[1]),
                              zip(prompts, sp)))
        assert got == expect


class _FakeEngine:
    def __init__(self, path, device, quantize=None):
        self.device = device


@pytest.mark.parametrize("mode,quant,device,want", [
    ("on", "f32", "cpu", "native"), ("auto", "q8_0", "cpu", "native"),
    ("auto", "f32", "cpu", "torch"), ("off", "q8_0", "cpu", "torch"),
    ("on", "q8_0", "cuda", "torch"),
])
def test_make_llm_engine(tmp_path, monkeypatch, mode, quant, device, want):
    """The JAX CLI's rule: on a CPU device ``on`` always and ``auto`` for a
    Q8_0/Q4_0 GGUF run the native engine; on CUDA the flag is ignored (the
    device is faked: the torch engine is a stand-in, and the native engine
    must not be built)."""
    path = tmp_path / "llm.gguf"
    write_synthetic_llm_gguf(str(path), n_audio=64, seed=0, quant=quant)
    monkeypatch.setattr(llm_mod, "LLMEngine", _FakeEngine)
    if device == "cuda":
        monkeypatch.setattr(llm_cpu, "NativeCpuLLMEngine", None)  # calling it would raise
    args = types.SimpleNamespace(cpu_native=mode, model=str(path), llm_quant="")
    eng = cli._make_llm_engine(args, torch.device(device))
    assert isinstance(eng, NativeCpuLLMEngine if want == "native" else _FakeEngine)
    if want == "torch":
        assert eng.device == torch.device(device)


def test_make_llm_engine_unavailable(tmp_path, monkeypatch, capsys):
    """With the library unavailable, ``on`` raises and ``auto`` falls back
    to the torch engine with one stderr line saying why."""
    path = tmp_path / "llm.gguf"
    write_synthetic_llm_gguf(str(path), n_audio=64, seed=0, quant="q8_0")
    monkeypatch.setattr(llm_cpu, "q8_available", lambda: False)
    args = types.SimpleNamespace(cpu_native="on", model=str(path), llm_quant="")
    with pytest.raises(RuntimeError, match="native q8 runtime unavailable"):
        cli._make_llm_engine(args, torch.device("cpu"))
    args.cpu_native = "auto"
    assert isinstance(cli._make_llm_engine(args, torch.device("cpu")), LLMEngine)
    err = capsys.readouterr().err
    assert err.count("the native CPU engine did not load") == 1


def test_cpu_native_env_default(monkeypatch):
    """MIOTTS_CPU_NATIVE=1/0 sets the --cpu-native default."""
    for env, want in (("1", "on"), ("on", "on"), ("0", "off"), ("", "auto")):
        monkeypatch.setenv("MIOTTS_CPU_NATIVE", env)
        assert cli.build_parser().get_default("cpu_native") == want


def test_no_native_env(monkeypatch):
    """MIOTTS_NO_NATIVE keeps the library unloaded, with its reason."""
    monkeypatch.setenv("MIOTTS_NO_NATIVE", "1")
    for name, value in (("_lib", None), ("_tried", False), ("_reason", "")):
        monkeypatch.setattr(native, name, value)  # put back after the test
    assert not native.q8_available()
    assert "MIOTTS_NO_NATIVE" in native.unavailable_reason()


@pytest.mark.parametrize("quant", ["q8_0", "q4_0", "f32"])
def test_embed_engine_choice_matches_jax(tmp_path, quant):
    """MioTTSEngine on a CPU device picks the native engine for a Q8_0/Q4_0
    GGUF and the torch engine otherwise, as the JAX MioTTSEngine picks; its
    pipeline runs without the process-wide sync check, so an unload and
    reload on another thread may use the card meanwhile."""
    from miotts_tpu import embed as jax_embed
    from miotts_tpu_torch import embed
    from miotts_tpu_torch.testing import tiny_codec_config, write_synthetic_miocodec_gguf

    codec, llm = tmp_path / "codec.gguf", tmp_path / f"llm_{quant}.gguf"
    write_synthetic_miocodec_gguf(str(codec), tiny_codec_config(), seed=0)
    write_synthetic_llm_gguf(str(llm), n_audio=128, seed=1, quant=quant)
    eng = embed.MioTTSEngine(str(codec), llm_model=str(llm), device=torch.device("cpu"))
    assert eng.pipeline.check_syncs is False
    got = eng._ensure_llm()
    want = jax_embed.MioTTSEngine(str(codec), llm_model=str(llm))._ensure_llm()
    assert isinstance(got, NativeCpuLLMEngine) == (quant != "f32") == (
        type(want).__name__ == "NativeCpuLLMEngine")
    eng.unload_llm()
    assert eng._ensure_llm() is not got
