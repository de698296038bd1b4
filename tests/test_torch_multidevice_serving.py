"""Multi-device serving in the port on logical CPU ranks
(MIOTTS_LOGICAL_DEVICES=8): the cases of tests/test_multidevice_serving.py.
``--mio-backend-devices`` builds a (dp, tp) mesh; the batcher's lanes and
the codec micro-batches split over dp, the LLM over tp; greedy codes equal
the single-device engine's, at tp 2 and at tp 4 over the tiny LLM's 2 kv
heads."""

import concurrent.futures
import json

import numpy as np
import pytest
import torch

from miotts_tpu_torch.gguf.writer import save_embedding_gguf
from miotts_tpu_torch.models.sampling import SamplerParams
from miotts_tpu_torch.parallel.mesh import LOGICAL_ENV, TPGroup, logical_devices
from miotts_tpu_torch.serving.engine import ServingEngine
from miotts_tpu_torch.serving.state import ServerConfig, parse_request_json
from miotts_tpu_torch.testing import (
    tiny_codec_config, write_synthetic_llm_gguf, write_synthetic_miocodec_gguf)

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def logical_ranks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(LOGICAL_ENV, "8")
        mp.setenv("MIOTTS_PLATFORM", "cpu")
        yield


def _mk_cfg(d, emb_path, backend_devices, n_parallel=4, tensor_parallel=1, **kw):
    return ServerConfig(
        model_vocoder=str(d / "codec.gguf"), model=str(d / "llm.gguf"),
        output_dir=str(d / "out"), n_parallel=n_parallel, n_predict=32, n_ctx=128,
        mio_backend_devices=backend_devices, tensor_parallel=tensor_parallel,
        reference_file_json=json.dumps({"key": "preset", "path": str(emb_path)}), **kw)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("tmdsrv")
    cfg_codec = tiny_codec_config()
    write_synthetic_miocodec_gguf(str(d / "codec.gguf"), cfg_codec, seed=0)
    write_synthetic_llm_gguf(str(d / "llm.gguf"), n_audio=cfg_codec.vocab_size, seed=1)
    # code-dense LLM: a quantized greedy generation then holds audio codes
    write_synthetic_llm_gguf(str(d / "llm_dense.gguf"), n_audio=cfg_codec.vocab_size, seed=1,
                             audio_logit_scale=3.0)
    emb_path = d / "voice.emb.gguf"
    save_embedding_gguf(emb_path, np.random.RandomState(0).randn(
        cfg_codec.decoder_adanorm_dim).astype(np.float32))
    return d, emb_path, cfg_codec


@pytest.fixture(scope="module")
def engines(assets):
    d, emb_path, _ = assets
    single = ServingEngine(_mk_cfg(d, emb_path, ""), CPU)
    meshed = ServingEngine(_mk_cfg(d, emb_path, "all", n_parallel=8), CPU)
    yield single, meshed
    single.shutdown()
    meshed.shutdown()


def _codes(eng, body):
    out: dict = {}
    codes = eng._generate_codes(parse_request_json(body, eng.cfg), out)
    return codes, out


def _synth_ok(eng, body):
    out: dict = {}
    audio, _sr = eng.run_tts_request(parse_request_json(body, eng.cfg), out)
    assert out["ok"] and audio.size > 0
    return out


def test_state_sharded_across_devices(engines):
    """Lanes land on every rank: one state a dp rank, a contiguous block of
    lanes each, on its rank's device; slicing is off on a mesh."""
    _, meshed = engines
    assert meshed.mesh is not None and meshed.mesh.devices.size == 8
    b = meshed.batcher
    assert [r.rank_id for r in b.ranks] == list(range(8)) and b.per_rank == 1
    assert all(r.state.cache_k.shape[1] == 1 and r.device == CPU for r in b.ranks)
    assert len({r.state.cache_k.data_ptr() for r in b.ranks}) == 8
    assert b._where(5) == (b.ranks[5], 0)
    assert b.slice_chunks is False and b.widths() == [8]


def test_generation_matches_single_device(engines):
    single, meshed = engines
    body = {"text": "match me", "reference_key": "preset", "n_predict": 24, "temp": 0.0,
            "seed": 7}
    codes_s, out_s = _codes(single, body)
    codes_m, out_m = _codes(meshed, body)
    assert codes_s == codes_m
    assert out_s["n_tokens"] == out_m["n_tokens"] > 0


@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_serving_matches_single_device(assets, engines, tp):
    """--tensor-parallel over the 8 ranks (dp 8/tp): the LLM's leaves split
    a rank each (at tp 4 over its 2 kv heads), the serving flow works end
    to end, and greedy codes equal the single-device engine's."""
    d, emb_path, _ = assets
    single, _ = engines
    eng = ServingEngine(_mk_cfg(d, emb_path, "all", n_parallel=4, tensor_parallel=tp), CPU)
    try:
        assert eng.mesh.shape == {"dp": 8 // tp, "tp": tp}
        g = eng.llm.weights
        assert isinstance(g, TPGroup) and g.tp == tp
        assert [str(r) for r in g.ranks] == [f"cpu:{i}" for i in range(tp)]
        full = eng.batcher.ranks[1].w.shards[0]["wqkv"].shape[-1]
        assert full == (4 // tp + 2 * max(1, 2 // tp)) * 8  # q_r | k_r | v_r, head dim 8
        assert len(eng.batcher.ranks) == 8 // tp and eng.batcher.n_lanes == 8 // tp * (
            -(-4 // (8 // tp)))
        assert isinstance(eng.batcher.state.cache_k, tuple) and len(eng.batcher.state.cache_k) == tp
        body = {"text": "match me tp", "reference_key": "preset", "n_predict": 24, "temp": 0.0,
                "seed": 5}
        assert _codes(single, body)[0] == _codes(eng, body)[0]
        _synth_ok(eng, {"text": "tp synth", "reference_key": "preset", "n_predict": 12})
        # the engine's own B = 1 generation (the oversized-prompt path) runs
        # on dp rank 0's group, its KV cache split over the group
        args = ("one lane", 16, 64, SamplerParams(temp=0.0))
        assert (eng.llm.generate_audio_tokens(*args)
                == single.llm.generate_audio_tokens(*args))
    finally:
        eng.shutdown()


@pytest.mark.parametrize("quant", ["int8", "output_int8", "output_int4", "int8_output_int4"])
def test_quantized_tensor_parallel_serving(assets, quant):
    """``--llm-quant`` on a tp mesh: the quantized leaves split like dense
    ones (the head's over the vocab when it divides), and greedy codes
    equal the same-quant single-device engine's."""
    d, emb_path, _ = assets
    s_cfg = _mk_cfg(d, emb_path, "", n_parallel=2, llm_quant=quant)
    s_cfg.model = str(d / "llm_dense.gguf")
    single = ServingEngine(s_cfg, CPU)
    t_cfg = _mk_cfg(d, emb_path, "all", n_parallel=4, tensor_parallel=2, llm_quant=quant)
    t_cfg.model = str(d / "llm_dense.gguf")
    tp = ServingEngine(t_cfg, CPU)
    try:
        assert single.llm.quantize == quant
        sh = tp.llm.weights.shards[1]
        head = sh["output"]
        assert isinstance(head, dict) and tp.llm.weights.head_split
        key = "q4i8" if quant.endswith("int4") else "q8"
        assert key in head and head[key].shape[-1] == single.llm.weights["output"][key].shape[-1] // 2
        layers_quant = quant in ("int8", "int8_output_int4")
        assert isinstance(sh["wqkv"], dict) == layers_quant
        body = {"text": f"{quant} tp", "reference_key": "preset", "n_predict": 24,
                "temp": 0.0, "seed": 3}
        assert _codes(single, body)[0] == _codes(tp, body)[0]
        _synth_ok(tp, {"text": "quant synth", "reference_key": "preset", "n_predict": 12})
    finally:
        single.shutdown()
        tp.shutdown()


def test_tensor_parallel_streaming_request(assets):
    """Streaming synthesis through a tp engine: audio arrives before the
    codes are complete."""
    d, emb_path, _ = assets
    cfg = _mk_cfg(d, emb_path, "all", n_parallel=4, tensor_parallel=2)
    cfg.model = str(d / "llm_dense.gguf")
    eng = ServingEngine(cfg, CPU)
    try:
        rp = parse_request_json({"text": "stream over tp", "reference_key": "preset",
                                 "n_predict": 96, "stream_audio": True}, eng.cfg)
        seq: list[str] = []
        out: dict = {}
        audio, _sr = eng.run_streaming_request(
            rp, out, on_audio=lambda pcm: seq.append("audio"),
            on_codes=lambda codes: seq.append("codes_done"))
        assert out["ok"] and audio.size > 0
        assert "audio" in seq and "codes_done" in seq
        assert seq.index("audio") < seq.index("codes_done"), seq
    finally:
        eng.shutdown()


def test_codec_devices_disjoint_placement(assets, capsys):
    """--codec-devices gives the codec a dp mesh of its own (its batcher's
    pipelines on those ranks), serial and overlap requests work, greedy
    codes stay the plain engine's; an overlap with the LLM mesh warns."""
    d, emb_path, _ = assets
    cfg = _mk_cfg(d, emb_path, "0,1,2,3", n_parallel=4, codec_devices="4,5")
    cfg.model = str(d / "llm_dense.gguf")
    eng = ServingEngine(cfg, CPU)
    p_cfg = _mk_cfg(d, emb_path, "")
    p_cfg.model = cfg.model
    single = ServingEngine(p_cfg, CPU)
    try:
        assert eng.mesh.devices.size == 4 and eng.codec_mesh is not eng.mesh
        devs = logical_devices("cpu")
        assert list(eng.codec_mesh.devices.reshape(-1)) == [devs[4], devs[5]]
        assert len(eng.codec_batcher.pipelines) == 2 and eng.codec_batcher.max_batch == 4
        body = {"text": "disjoint codec", "reference_key": "preset", "n_predict": 24,
                "temp": 0.0, "seed": 9}
        assert _codes(eng, body)[0] == _codes(single, body)[0]
        _synth_ok(eng, {"text": "serial", "reference_key": "preset", "n_predict": 16})
        _synth_ok(eng, {"text": "overlapped", "reference_key": "preset", "n_predict": 48,
                        "overlap_synthesis": True})
        assert sum(eng.codec_batcher.rank_decodes) >= 2
    finally:
        eng.shutdown()
        single.shutdown()
    assert "warning" not in capsys.readouterr().err
    cfg = _mk_cfg(d, emb_path, "0,1", n_parallel=2, codec_devices="1,2")
    cfg.model = ""
    ServingEngine(cfg, CPU).shutdown()
    assert "--codec-devices overlaps the LLM mesh on [1]" in capsys.readouterr().err


def test_reference_generation_under_mesh(tmp_path):
    """Voice cloning on a dp/tp engine gives the single-device embedding,
    and the cloned reference synthesizes."""
    from miotts_tpu_torch.runtime.audio_io import save_wav16
    from miotts_tpu_torch.testing import write_synthetic_wavlm_gguf

    d = tmp_path
    cfg_codec = tiny_codec_config(global_encoder_input_channels=32)
    write_synthetic_miocodec_gguf(str(d / "codec.gguf"), cfg_codec, seed=0)
    write_synthetic_llm_gguf(str(d / "llm.gguf"), n_audio=cfg_codec.vocab_size, seed=1)
    write_synthetic_wavlm_gguf(str(d / "wavlm.gguf"), seed=2)
    emb_path = d / "voice.emb.gguf"
    save_embedding_gguf(emb_path, np.random.RandomState(0).randn(
        cfg_codec.decoder_adanorm_dim).astype(np.float32))
    sr = 24000
    t = np.arange(sr // 2) / sr
    save_wav16(d / "ref.wav", (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32), sr)
    single = ServingEngine(_mk_cfg(d, emb_path, "", wavlm_model=str(d / "wavlm.gguf")), CPU)
    mesh_eng = ServingEngine(_mk_cfg(d, emb_path, "all", tensor_parallel=2,
                                     wavlm_model=str(d / "wavlm.gguf")), CPU)
    try:
        e1 = single.generate_reference(str(d / "ref.wav"), "clone", 20.0)
        e2 = mesh_eng.generate_reference(str(d / "ref.wav"), "clone", 20.0)
        np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-5)
        _synth_ok(mesh_eng, {"codes": [1, 2, 3, 4], "reference_key": "clone"})
    finally:
        single.shutdown()
        mesh_eng.shutdown()


def test_warmup_under_mesh(assets):
    """--warmup on a dp/tp engine: the warm calls run on every dp rank
    against tp-split weights, then requests serve."""
    d, emb_path, _ = assets
    cfg = _mk_cfg(d, emb_path, "all", n_parallel=4, tensor_parallel=2, warmup=True)
    eng = ServingEngine(cfg, CPU)
    try:
        if eng._warmup_bg_thread is not None:
            eng._warmup_bg_thread.join(timeout=300)
        assert eng.warmup_bg_done and not eng.batcher.split_cold_until_warm
        assert all(r.warm_state is None for r in eng.batcher.ranks)
        assert (32, 1) in eng.batcher._warm_prefills
        _synth_ok(eng, {"codes": list(range(24)), "reference_key": "preset"})
        _synth_ok(eng, {"text": "warm mesh", "reference_key": "preset", "n_predict": 16})
    finally:
        eng.shutdown()


def test_tensor_parallel_requires_devices(assets):
    d, emb_path, _ = assets
    with pytest.raises(ValueError, match="--tensor-parallel requires --mio-backend-devices"):
        ServingEngine(_mk_cfg(d, emb_path, "", tensor_parallel=2), CPU)
    with pytest.raises(ValueError, match="--tensor-parallel 2 does not divide the 3 backend"):
        ServingEngine(_mk_cfg(d, emb_path, "0,1,2", tensor_parallel=2), CPU)


def test_single_backend_device_is_no_mesh(assets):
    """One backend device at tp 1 serves without a mesh, as in JAX."""
    d, emb_path, _ = assets
    cfg = _mk_cfg(d, emb_path, "3")
    cfg.model = ""
    eng = ServingEngine(cfg, CPU)
    try:
        assert eng.mesh is None and eng.codec_mesh is None
        assert eng.codec_batcher.pipelines == [eng.pipeline]
    finally:
        eng.shutdown()


def test_codec_batch_sharded_and_matches(engines):
    """A codec group splits over the dp ranks (a block each) and gives the
    single-device waveforms."""
    single, meshed = engines
    cb = meshed.codec_batcher
    assert cb.max_batch == 8 and len(cb.pipelines) == 8
    rng = np.random.RandomState(3)
    emb = meshed.ref_cache.get("preset")
    codes = [rng.randint(0, single.pipeline.config.vocab_size, n).tolist() for n in (40, 33, 21)]
    before = list(cb.rank_decodes)
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        got = list(ex.map(lambda c: cb.synthesize(c, emb), codes))
    grew = [a - b for a, b in zip(cb.rank_decodes, before)]
    assert sum(grew) >= 3 and max(grew) >= 1
    for c, r_m in zip(codes, got):
        r_s = single.codec_batcher.synthesize(c, emb)
        assert r_s.audio.size == r_m.audio.size > 0
        np.testing.assert_allclose(r_m.audio, r_s.audio, rtol=1e-4, atol=1e-5)


def test_full_request_flow_on_mesh(engines):
    _, meshed = engines
    out = _synth_ok(meshed, {"text": "hello mesh", "reference_key": "preset", "n_predict": 16})
    assert out["codes"] > 0
    assert len({r.state.cache_k.data_ptr() for r in meshed.batcher.ranks}) == 8


def test_concurrent_requests_spread_over_mesh(engines):
    """Concurrent requests attach to lanes of different dp ranks."""
    _, meshed = engines
    b = meshed.batcher
    seen: set[int] = set()
    real = b._prefill_group

    def spy(bucket, group):
        seen.update(b._where(it[0])[0].index for it in group)
        return real(bucket, group)

    b._prefill_group = spy
    try:
        def one(i):
            out = _synth_ok(meshed, {"text": f"lane {i}", "reference_key": "preset",
                                     "n_predict": 12})
            return out["codes"]

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            results = list(ex.map(one, range(6)))
    finally:
        del b._prefill_group
    assert all(n > 0 for n in results)
    assert len(seen) >= 2, seen
