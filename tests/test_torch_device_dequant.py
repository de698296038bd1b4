"""The port's packed weight upload (miotts_tpu_torch.runtime.device_dequant)
on the CPU, at tiny widths.

Raw-payload leaves (Q8_0, Q4_0, F16) dequantized, transposed and fused from
one packed buffer a dtype are bit-equal to the per-leaf route's host
dequant and to the JAX package's packed leaves, generation does not
change, the deploy artifact replays bit-equal leaves without reading a
tensor payload (and never reads the JAX package's artifacts), the per-leaf
fallback gives the same leaves, and the codec's and WavLM's loaders get
from ``device_put_packed`` what the per-leaf upload gives."""

import os
import shutil

import numpy as np
import pytest
import torch

from miotts_tpu.models.llm import load_llm_gguf as jax_load_llm_gguf
from miotts_tpu_torch.convert import llm_params_from_jax
from miotts_tpu_torch.gguf import GGUFReader
from miotts_tpu_torch.gguf.writer import GGUFWriter
from miotts_tpu_torch.models.llm import LLMEngine, load_llm_gguf
from miotts_tpu_torch.models.miocodec import load_miocodec
from miotts_tpu_torch.models.sampling import SamplerParams
from miotts_tpu_torch.models.wavlm import load_wavlm
from miotts_tpu_torch.runtime import device_dequant as dd
from miotts_tpu_torch.testing import (
    tiny_codec_config, write_synthetic_llm_gguf, write_synthetic_mel_vocoder_gguf,
    write_synthetic_miocodec_gguf, write_synthetic_wavlm_gguf)

torch.set_num_threads(1)
CPU = torch.device("cpu")
QUANT_MODES = ("", "q8_0", "int8_output_int4", "output")


@pytest.fixture(scope="module", params=["q8_0", "q4_0", "f16"])
def gguf_path(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("devdeq") / f"dev_deq_{request.param}.gguf"
    write_synthetic_llm_gguf(str(path), n_audio=64, dim=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, ffn=96, seed=3, quant=request.param)
    return str(path)


def _load(path, monkeypatch, packed: bool, quantize=""):
    monkeypatch.setenv("MIOTTS_DEVICE_DEQUANT", "1" if packed else "0")
    return load_llm_gguf(path, CPU, quantize=quantize)


def _assert_trees_equal(a, b, what=""):
    """Same structure, dtypes, shapes and bits."""
    if a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{what}/{i}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
        assert torch.equal(a, b), what


@pytest.mark.parametrize("quantize", QUANT_MODES)
def test_packed_equals_per_leaf(gguf_path, monkeypatch, quantize):
    """Every leaf of the packed route bit-equal to the per-leaf route's, the
    dense matmul leaves shipped raw (none under a layer quantization)."""
    cfg_h, w_h, _ = _load(gguf_path, monkeypatch, False, quantize)
    raw = []
    real_add_raw = dd.PackedLoader.add_raw

    def add_raw(self, key, *a, **k):
        raw.append(key[1])
        return real_add_raw(self, key, *a, **k)

    monkeypatch.setattr(dd.PackedLoader, "add_raw", add_raw)
    before = dict(dd.routes)
    cfg_d, w_d, _ = _load(gguf_path, monkeypatch, True, quantize)
    assert cfg_h == cfg_d
    _assert_trees_equal(w_h, w_d)
    assert dd.routes["packed"] == before["packed"] + 1 and dd.routes["fallback"] == before[
        "fallback"]
    want = {"token_embd.weight"}
    if quantize in ("", "output"):
        want |= {"blk.{i}.attn_q.weight", "blk.{i}.attn_output.weight",
                 "blk.{i}.ffn_gate.weight", "blk.{i}.ffn_down.weight"}
    if quantize == "":
        want.add("output.weight")
    assert set(raw) == want
    assert w_d["token_embd"].dtype == torch.bfloat16 and w_d["attn_norm"].dtype == torch.float32


def test_f32_source_stays_on_the_host_path(tmp_path, monkeypatch):
    """F32 tensors have no device dequant: every leaf goes through
    add_array, pre-cast, and still equals the per-leaf route's."""
    path = str(tmp_path / "f32.gguf")
    write_synthetic_llm_gguf(path, n_audio=32, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                             ffn=48, seed=0)
    _, w_h, _ = _load(path, monkeypatch, False)
    _, w_d, _ = _load(path, monkeypatch, True)
    _assert_trees_equal(w_h, w_d)


@pytest.mark.parametrize("quantize", ["", "q8_0"])
def test_packed_equals_jax_packed(gguf_path, monkeypatch, quantize):
    """The port's packed leaves equal the JAX package's packed leaves (its
    tree mapped to the port's layout: bf16 through f32, a [V, D] head)."""
    monkeypatch.setenv("MIOTTS_DEVICE_DEQUANT", "1")
    jcfg, jw, _ = jax_load_llm_gguf(gguf_path, quantize=quantize)
    jw = {k: (None if v is None else {sk: np.asarray(a) for sk, a in v.items()}
              if isinstance(v, dict) else np.asarray(v.astype("float32")))
          for k, v in jw.items()}
    _, want = llm_params_from_jax(jcfg, jw, CPU)
    _, got, _ = load_llm_gguf(gguf_path, CPU, quantize=quantize)
    _assert_trees_equal(want, got)


def test_generation_identical(gguf_path, monkeypatch):
    """Greedy generation through the engine does not change with the route."""
    sp = SamplerParams(temp=0.0, top_k=1, seed=0)
    toks = []
    for setting in ("0", "1"):
        monkeypatch.setenv("MIOTTS_DEVICE_DEQUANT", setting)
        toks.append(LLMEngine(gguf_path, CPU).generate_audio_tokens("hello", n_predict=12,
                                                                     sampler=sp))
    assert toks[0] == toks[1] and toks[0]


def test_single_block_tensor_reader_closes(tmp_path):
    """A quantized tensor of ONE 32-element block stages compact copies, not
    mmap views, so closing the reader does not raise BufferError."""
    path = str(tmp_path / "oneblock.gguf")
    w = GGUFWriter(path, arch="test")
    vals = (np.arange(32, dtype=np.float32) - 16.0) / 4.0
    w.add_tensor_q8_0("tiny", vals.reshape(1, 32))
    w.write()
    r = GGUFReader(path)
    pk = dd.PackedLoader(CPU)
    assert pk.add_raw("tiny", r, ["tiny"], out_dtype=torch.float32) is not None
    r.close()
    out = pk.finalize()["tiny"].numpy()
    with GGUFReader(path) as r2:
        np.testing.assert_array_equal(out, r2.tensor("tiny"))
    q = np.round(vals / (np.abs(vals).max() / 127.0))
    scale = np.float32(np.float16(np.abs(vals).max() / 127.0))
    np.testing.assert_allclose(out, (q * scale).reshape(1, 32), rtol=1e-3)


def test_build_leaf_equals_the_loader(gguf_path, monkeypatch):
    """``build_leaf`` builds one fused, stacked leaf now: the loader's."""
    _, w, _ = _load(gguf_path, monkeypatch, False)
    with GGUFReader(gguf_path) as r:
        leaf = dd.build_leaf(r, ["blk.{i}.ffn_gate.weight", "blk.{i}.ffn_up.weight"], CPU,
                             n_layers=2, transpose=True)
        assert dd.build_leaf(r, ["blk.0.attn_norm.weight"], CPU) is None  # F32: no raw route
    assert leaf.dtype == torch.bfloat16 and torch.equal(leaf, w["w_gateup"])


def test_duplicate_leaf_key_rejected():
    pk = dd.PackedLoader(CPU)
    pk.add_array("k", np.ones(4, np.float32))
    with pytest.raises(AssertionError):
        pk.add_array("k", np.zeros(4, np.float32))


def test_packed_failure_falls_back_per_leaf(gguf_path, monkeypatch, capsys):
    """When the packed assembly fails, the load falls back to assembling
    leaf by leaf, prints the JAX package's line, and gives equal leaves."""
    _, w_ref, _ = _load(gguf_path, monkeypatch, False)

    def boom(*a, **k):
        raise RuntimeError("synthetic out of memory")

    monkeypatch.setattr(dd, "_assemble_packed", boom)
    before = dd.routes["fallback"]
    _, w_fb, _ = _load(gguf_path, monkeypatch, True)
    assert "falling back to per-leaf assembly" in capsys.readouterr().err
    assert dd.routes["fallback"] == before + 1 and dd.last_upload.route == "fallback"
    _assert_trees_equal(w_ref, w_fb)


@pytest.mark.parametrize("quant_mode", ["", "int8_output_int4"])
def test_packed_deploy_artifact_roundtrip(gguf_path, monkeypatch, tmp_path, capsys,
                                          quant_mode):
    """The artifact replays bit-equal leaves without touching a tensor
    payload: the second load succeeds with the reader's tensor reads
    poisoned."""
    monkeypatch.setenv("MIOTTS_DEVICE_DEQUANT", "1")
    monkeypatch.setenv("MIOTTS_PACKED_CACHE", str(tmp_path / "packed"))
    cfg1, w1, _ = load_llm_gguf(gguf_path, CPU, quantize=quant_mode)
    arts = list((tmp_path / "packed").glob("*.torch.packed.npz"))
    assert len(arts) == 1, arts

    def poisoned(self, name, *a, **k):
        raise AssertionError(f"artifact replay read tensor payload {name!r}")

    monkeypatch.setattr(GGUFReader, "tensor", poisoned)
    monkeypatch.setattr(GGUFReader, "tensor_raw", poisoned)
    before = dd.routes["replay"]
    cfg2, w2, _ = load_llm_gguf(gguf_path, CPU, quantize=quant_mode)
    assert dd.routes["replay"] == before + 1
    assert "mio: packed artifact replay: read" in capsys.readouterr().err
    assert cfg1 == cfg2
    _assert_trees_equal(w1, w2)


def test_jax_artifact_never_read(gguf_path, monkeypatch, tmp_path):
    """The JAX package's artifact, in the same directory and even at the
    port's own file name, is never replayed: the port loads from the GGUF
    and writes its own."""
    cache = tmp_path / "packed"
    monkeypatch.setenv("MIOTTS_DEVICE_DEQUANT", "1")
    monkeypatch.setenv("MIOTTS_PACKED_CACHE", str(cache))
    jax_load_llm_gguf(gguf_path, quantize="")
    (jax_art,) = cache.glob("*.packed.npz")
    _, w_ref, _ = _load(gguf_path, monkeypatch, False)
    monkeypatch.setenv("MIOTTS_DEVICE_DEQUANT", "1")
    sig = f"llm|bfloat16||{dd.ARTIFACT_TAG}"
    port_art = dd.packed_artifact_path(gguf_path, sig)
    assert port_art.parent == cache and port_art.name != jax_art.name
    shutil.copy(jax_art, port_art)  # a JAX file where the port looks
    before = dict(dd.routes)
    _, w, _ = load_llm_gguf(gguf_path, CPU)
    assert dd.routes["replay"] == before["replay"] and dd.routes["packed"] == before["packed"] + 1
    _assert_trees_equal(w_ref, w)
    assert dd.load_packed_artifact(port_art, CPU) is not None  # now the port's own
    assert dd.load_packed_artifact(jax_art, CPU) is None


def test_artifact_opt_in(monkeypatch, gguf_path):
    monkeypatch.delenv("MIOTTS_PACKED_CACHE", raising=False)
    assert dd.packed_artifact_path(gguf_path, "x") is None
    monkeypatch.setenv("MIOTTS_PACKED_CACHE", "1")
    path = dd.packed_artifact_path(gguf_path, "x")
    assert path.parent == (
        __import__("pathlib").Path(os.path.expanduser("~")) / ".cache" / "miotts_tpu_torch"
        / "packed")
    assert path != dd.packed_artifact_path(gguf_path, "y")


def test_device_put_packed_identity(monkeypatch):
    """One packed upload returns the per-leaf upload's leaves, native dtypes
    kept, across dtypes, 0-d leaves and nesting; tensors pass through."""
    monkeypatch.setenv("MIOTTS_DEVICE_DEQUANT", "1")
    rng = np.random.RandomState(0)
    ready = torch.arange(3)
    tree = {
        "a": rng.randn(33, 7).astype(np.float32),
        "nested": {"b": rng.randn(4, 5).astype(np.float16),
                   "c": rng.randint(-100, 100, (11,)).astype(np.int8)},
        "d": [rng.randn(2, 3, 4), np.asarray(3, np.int32)],
        "t": (rng.randn(6).astype(np.float32), ready),
        "none": None,
    }
    got = dd.device_put_packed(tree, CPU)
    assert got["t"][1] is ready and dd.last_upload.route == "packed"
    _assert_trees_equal(dd.tree_to_device(tree, CPU), got)
    assert got["d"][0].dtype == torch.float64 and got["d"][1].shape == ()


def _codec_and_wavlm(tmp_path):
    codec = tmp_path / "codec.gguf"
    write_synthetic_miocodec_gguf(str(codec), tiny_codec_config(
        global_encoder_input_channels=32), seed=0)
    mel = tmp_path / "mel.gguf"
    write_synthetic_mel_vocoder_gguf(str(mel), tiny_codec_config(
        model_type=1, n_mels=12, resnet_blocks=0, vocoder_upsample_rates=(4, 2, 2),
        vocoder_num_kernels=2), seed=0)
    wavlm = tmp_path / "wavlm.gguf"
    write_synthetic_wavlm_gguf(str(wavlm), seed=2)
    return codec, mel, wavlm


@pytest.mark.parametrize("model", ["codec", "mel", "wavlm"])
def test_loaders_use_device_put_packed(tmp_path, monkeypatch, model):
    """The codec's (wave, mel) and WavLM's loaders hand their host tree to
    one ``device_put_packed``: its leaves equal the per-leaf upload's."""
    path = dict(zip(("codec", "mel", "wavlm"), _codec_and_wavlm(tmp_path)))[model]
    load = load_wavlm if model == "wavlm" else load_miocodec
    trees = []
    for setting, route in (("0", "per_leaf"), ("1", "packed")):
        monkeypatch.setenv("MIOTTS_DEVICE_DEQUANT", setting)
        cfg, w = load(str(path), CPU)
        assert dd.last_upload.route == route
        trees.append(w)
    _assert_trees_equal(*trees)


def test_default_route_by_device(monkeypatch):
    monkeypatch.delenv("MIOTTS_DEVICE_DEQUANT", raising=False)
    assert not dd.device_dequant_enabled(CPU)
    assert dd.device_dequant_enabled(torch.device("cuda"))
    for setting, want in (("on", True), ("1", True), ("off", False), ("0", False)):
        monkeypatch.setenv("MIOTTS_DEVICE_DEQUANT", setting)
        assert dd.device_dequant_enabled(torch.device("cuda")) is want
        assert dd.device_dequant_enabled(CPU) is want


@pytest.mark.parametrize("preset,want", [(None, "1"), ("0", "0"), ("/some/dir", "/some/dir")])
def test_server_main_sets_packed_cache_default(monkeypatch, preset, want):
    """The server's entry point keeps the deploy artifact by default (=1),
    and leaves a value that is already set alone."""
    from miotts_tpu_torch.serving import server as server_mod

    seen = {}

    class FakeServer:
        def __init__(self, cfg, device):
            seen["device"] = device

        def serve_forever(self):
            seen["cache"] = os.environ.get("MIOTTS_PACKED_CACHE")

    monkeypatch.setattr(server_mod, "MioTTSServer", FakeServer)
    monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")
    if preset is None:  # set first, so that main()'s default is undone after the test
        monkeypatch.setenv("MIOTTS_PACKED_CACHE", "")
        monkeypatch.delenv("MIOTTS_PACKED_CACHE")
    else:
        monkeypatch.setenv("MIOTTS_PACKED_CACHE", preset)
    assert server_mod.main(["-mv", "codec.gguf"]) == 0
    assert seen == {"device": CPU, "cache": want}
