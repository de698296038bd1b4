"""Voice cloning in the port (miotts_tpu_torch) against the JAX package on
the CPU, at small sizes: the global encoder (tiny and full width), the
reference chain end to end on WAV, FLAC and mp3 references, each rung of
the fallback ladder, the reference-audio decoders (bit-equal to the
originals, apart from the mp3 copy's deliberate skip of a Xing/Info/VBRI
header frame), the CLI's voice-cloning flags, the server's
/mio/generate_reference (JSON and multipart) and the embeddable engine
(embed.py) on tests/test_embed.py's cases."""

import dataclasses
import json
import struct
import sys
import urllib.error
import urllib.request
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from flac_encoder import encode_flac  # noqa: E402
from mp3_oracles import have_oracles, lame_encode  # noqa: E402
from test_mp3 import MP3_FIXTURES  # noqa: E402  (real mp3 files, where the image has them)

from miotts_tpu import cli as jax_cli  # noqa: E402
from miotts_tpu import embed as jax_embed  # noqa: E402
from miotts_tpu.models import miocodec as jax_miocodec  # noqa: E402
from miotts_tpu.pipeline import MioTTSPipeline as JaxPipeline  # noqa: E402
from miotts_tpu.runtime import audio_io as jax_audio  # noqa: E402
from miotts_tpu.runtime import flac as jax_flac  # noqa: E402
from miotts_tpu.runtime import mp3 as jax_mp3  # noqa: E402
from miotts_tpu.serving.server import MioTTSServer as JaxServer  # noqa: E402
from miotts_tpu.serving.state import ServerConfig as JaxServerConfig  # noqa: E402
from miotts_tpu.testing import write_synthetic_miocodec_gguf as jax_write_codec  # noqa: E402
from miotts_tpu_torch import cli, embed  # noqa: E402
from miotts_tpu_torch.convert import miocodec_params_from_jax  # noqa: E402
from miotts_tpu_torch.gguf import GGUFReader  # noqa: E402
from miotts_tpu_torch.gguf.writer import load_embedding_gguf, save_embedding_gguf  # noqa: E402
from miotts_tpu_torch.models import miocodec  # noqa: E402
from miotts_tpu_torch.pipeline import MioTTSPipeline  # noqa: E402
from miotts_tpu_torch.runtime import audio_io, flac, mp3  # noqa: E402
from miotts_tpu_torch.serving.server import MioTTSServer  # noqa: E402
from miotts_tpu_torch.serving.state import ServerConfig  # noqa: E402
from miotts_tpu_torch.testing import (  # noqa: E402
    full_codec_config, tiny_codec_config, write_synthetic_llm_gguf,
    write_synthetic_miocodec_gguf, write_synthetic_wavlm_gguf)

torch.set_num_threads(1)
CPU = torch.device("cpu")
EMB_TOL = 1e-4
# the tiny WavLM's embed is 4 heads x 8 = 32 channels
CODEC = tiny_codec_config(global_encoder_input_channels=32)
needs_oracles = pytest.mark.skipif(not have_oracles(), reason="lame/mpg123 not in image")


def _tone(rate: int, secs: float, seed: int = 0, channels: int = 1) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(int(rate * secs)) / rate
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(t.size)
    if channels == 2:
        x = np.stack([x, 0.3 * np.sin(2 * np.pi * 330 * t)], axis=1)
    return x.astype(np.float32)


def _wav_bytes(x: np.ndarray, rate: int, bits: int = 16, fmt: int = 1,
               extensible: bool = False) -> bytes:
    """A WAV file of x ([n] or [n, ch] in [-1, 1]) at ``bits`` PCM or float."""
    x = x if x.ndim == 2 else x[:, None]
    ch = x.shape[1]
    if fmt == 3:
        data = x.astype("<f4" if bits == 32 else "<f8").tobytes()
    elif bits == 8:
        data = np.clip(np.rint(x * 127 + 128), 0, 255).astype(np.uint8).tobytes()
    elif bits == 24:
        v = np.clip(np.rint(x * 8388607), -8388608, 8388607).astype(np.int32).reshape(-1)
        data = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255], 1).astype(np.uint8).tobytes()
    else:
        scale = {16: 32767, 32: 2147483647}[bits]
        data = np.rint(x.astype(np.float64) * scale).astype({16: "<i2", 32: "<i4"}[bits]).tobytes()
    block = ch * bits // 8
    if extensible:
        fmt_body = struct.pack("<HHIIHHHHI16s", 0xFFFE, ch, rate, rate * block, block, bits, 22,
                               bits, 0, struct.pack("<H", fmt) + b"\x00" * 14)
    else:
        fmt_body = struct.pack("<HHIIHH", fmt, ch, rate, rate * block, block, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
            + b"LIST" + struct.pack("<I", 3) + b"abc\x00"  # an odd chunk, padded
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("clone")
    write_synthetic_miocodec_gguf(str(d / "codec.gguf"), CODEC, seed=0)
    write_synthetic_miocodec_gguf(str(d / "codec_noge.gguf"), CODEC, seed=0,
                                  with_global_encoder=False)
    write_synthetic_miocodec_gguf(str(d / "codec_static.gguf"),
                                  dataclasses.replace(CODEC, dynamic_global=False), seed=0)
    write_synthetic_wavlm_gguf(str(d / "wavlm.gguf"), seed=2)
    write_synthetic_llm_gguf(str(d / "llm.gguf"), n_audio=CODEC.vocab_size, seed=1)
    rng = np.random.RandomState(0)
    for name in ("voice_a", "voice_b"):
        save_embedding_gguf(d / f"{name}.emb.gguf",
                            rng.randn(CODEC.decoder_adanorm_dim).astype(np.float32))
    audio_io.save_wav16(d / "ref.wav", _tone(24000, 1.0), 24000)
    (d / "ref44_stereo.wav").write_bytes(_wav_bytes(_tone(44100, 1.2, 1, channels=2), 44100))
    pcm = np.rint(_tone(24000, 0.9, 2) * 32767).astype(np.int64)
    (d / "ref.flac").write_bytes(encode_flac(pcm, 24000, subframe_kind="lpc2"))
    (d / "codes.txt").write_text(" ".join(map(str, rng.randint(0, 128, 40))))
    return d


@pytest.fixture(scope="module")
def pipes(assets):
    """(JAX pipeline, port pipeline) on the same codec and WavLM files."""
    return (JaxPipeline(str(assets / "codec.gguf"), wavlm_path=str(assets / "wavlm.gguf")),
            MioTTSPipeline(str(assets / "codec.gguf"), CPU,
                           wavlm_path=str(assets / "wavlm.gguf")))


# -- the global encoder ----------------------------------------------------------------

@pytest.mark.parametrize("width", ["tiny", "full"])
def test_encode_global_embedding_matches_jax(tmp_path, width):
    """ConvNeXt backbone + attentive-stats pooling at T = 50, a ragged
    batch of two (one lane 31 frames), within 1e-4."""
    cfg = tiny_codec_config() if width == "tiny" else full_codec_config()
    path = tmp_path / "codec.gguf"
    if width == "tiny":
        write_synthetic_miocodec_gguf(str(path), cfg, seed=4)
    else:  # the trunk at tiny widths, the encoder at the 24 kHz codec's
        write_synthetic_miocodec_gguf(str(path), tiny_codec_config(**{
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name.startswith("global_encoder")}), seed=4)
    jcfg, jw = jax_miocodec.load_miocodec(str(path))
    pcfg, pw = miocodec_params_from_jax(jcfg, jw, CPU)
    assert (jcfg.global_encoder_input_channels, jcfg.global_encoder_dim) == (
        cfg.global_encoder_input_channels, cfg.global_encoder_dim)
    rng = np.random.RandomState(7)
    ssl = rng.randn(2, 50, cfg.global_encoder_input_channels).astype(np.float32)
    lengths = np.array([50, 31], np.int32)
    ssl[1, 31:] = 0.0
    ref = np.asarray(jax_miocodec.encode_global_embedding(
        jcfg, jax.tree.map(jnp.asarray, jw), jnp.asarray(ssl), jnp.asarray(lengths)))
    got = miocodec.encode_global_embedding(pcfg, pw, torch.from_numpy(ssl),
                                           torch.from_numpy(lengths)).numpy()
    assert got.shape == ref.shape == (2, cfg.global_encoder_output_channels)
    assert np.abs(got - ref).max() <= EMB_TOL


def test_global_encoder_loaded_as_jax(assets):
    """The port's loader keeps the global encoder's subtree, leaf for leaf
    as the JAX loader reads it; a codec without it has none."""
    _, jw = jax_miocodec.load_miocodec(str(assets / "codec.gguf"))
    _, pw = miocodec.load_miocodec(str(assets / "codec.gguf"), CPU)
    ref = jax.tree_util.tree_leaves_with_path(jw["global_encoder"])
    got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), pw["global_encoder"]))
    assert [p for p, _ in got] == [p for p, _ in ref]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, ref))
    _, pw2 = miocodec.load_miocodec(str(assets / "codec_noge.gguf"), CPU)
    assert "global_encoder" not in pw2
    assert MioTTSPipeline(str(assets / "codec_noge.gguf"), CPU).has_global_encoder is False


def test_global_encoder_flag_leaves_other_draws(tmp_path):
    """Writing the global encoder appends its tensors: every other tensor
    of the file is the same with the flag on or off, as in JAX's writer."""
    for flag in (True, False):
        write_synthetic_miocodec_gguf(str(tmp_path / f"{flag}.gguf"), CODEC, seed=3,
                                      with_global_encoder=flag)
    jax_write_codec(str(tmp_path / "jax.gguf"), CODEC, seed=3, with_global_encoder=True)
    assert (tmp_path / "True.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()
    with GGUFReader(tmp_path / "True.gguf") as a, GGUFReader(tmp_path / "False.gguf") as b:
        extra = [n for n in a.tensors if n not in b.tensors]
        assert extra and all(n.startswith("global_encoder.") for n in extra)
        for name in b.tensors:
            assert np.array_equal(a.tensor(name), b.tensor(name)), name


# -- the reference chain ---------------------------------------------------------------

def _mp3_ref(d: Path) -> Path:
    p = d / "ref.mp3"
    if not p.exists():
        p.write_bytes(lame_encode(_tone(24000, 1.0, 3), 24000, bitrate=64))
    return p


@pytest.mark.parametrize("ref", ["ref.wav", "ref44_stereo.wav", "ref.flac",
                                 pytest.param("ref.mp3", marks=needs_oracles)])
def test_reference_to_embedding_matches_jax(assets, pipes, ref):
    """A 24 kHz WAV, a 44.1 kHz 16-bit stereo WAV, a FLAC and an mp3: the
    same embedding within 1e-4, on the ssl rung."""
    jp, pp = pipes
    path = _mp3_ref(assets) if ref == "ref.mp3" else assets / ref
    want = jp.reference_to_embedding(str(path))
    got, stats = pp.reference_embedding(str(path))
    assert got.shape == want.shape == (CODEC.decoder_adanorm_dim,) and got.dtype == np.float32
    assert np.abs(got - want).max() <= EMB_TOL
    assert stats.rung == "ssl" and stats.bucket == pp.wavlm.pick_wav_bucket(stats.n_samples)
    assert stats.frames == pp.wavlm.config.conv_out_len(stats.bucket)


def test_reference_max_seconds_cut(assets, pipes):
    jp, pp = pipes
    want = jp.reference_to_embedding(str(assets / "ref.wav"), 0.5)
    got, stats = pp.reference_embedding(str(assets / "ref.wav"), 0.5)
    assert stats.n_samples == 8000 and np.abs(got - want).max() <= EMB_TOL


def _jax_rung(jp, path: str) -> str:
    """The rung the JAX pipeline's fused chain took on ``path``."""
    wav16k = jp.wavlm.preprocess_reference(path, jp.config.sample_rate, 20.0)
    padded = np.zeros((1, jp.wavlm.pick_wav_bucket(wav16k.size)), np.float32)
    padded[0, :wav16k.size] = wav16k
    packed = np.asarray(jp._ref_fused_fn(jp.weights, jp.wavlm.weights, jnp.asarray(padded),
                                         jnp.asarray([wav16k.size], jnp.int32)))
    d = jp.config.decoder_adanorm_dim
    return "ssl" if packed[d] > 0 else "ssl_pre" if packed[d + 1] > 0 else "audio_stat"


@pytest.mark.parametrize("rung,leaf", [("ssl_pre", ("layers", 1, "ffn_w2")),
                                       ("audio_stat", ("transformer_norm_w",))])
def test_fallback_rung_matches_jax(assets, rung, leaf):
    """A non-finite weight forces a rung: NaN after the transformer input
    (ssl non-finite, ssl_pre finite) or before it (both non-finite, the
    host's audio statistics through the encoder). Both packages take the
    same rung and give the same embedding."""
    jp = JaxPipeline(str(assets / "codec.gguf"), wavlm_path=str(assets / "wavlm.gguf"))
    pp = MioTTSPipeline(str(assets / "codec.gguf"), CPU, wavlm_path=str(assets / "wavlm.gguf"))

    def poison(tree, tensor):
        *parents, last = leaf
        for k in parents:
            tree = tree[k]
        tree[last] = tree[last] * (jnp.nan if not tensor else float("nan"))

    poison(jp.wavlm.weights, False)
    poison(pp.wavlm.weights, True)
    path = str(assets / "ref.wav")
    want = jp.reference_to_embedding(path)
    got, stats = pp.reference_embedding(path)
    assert stats.rung == _jax_rung(jp, path) == rung
    assert np.isfinite(got).all() and np.abs(got - want).max() <= EMB_TOL


@pytest.mark.parametrize("case", ["static", "no_global_encoder", "no_wavlm"])
def test_reference_errors_match_jax(assets, case):
    codec = {"static": "codec_static.gguf", "no_global_encoder": "codec_noge.gguf",
             "no_wavlm": "codec.gguf"}[case]
    wl = None if case == "no_wavlm" else str(assets / "wavlm.gguf")
    errs = []
    for make in (lambda: JaxPipeline(str(assets / codec), wavlm_path=wl),
                 lambda: MioTTSPipeline(str(assets / codec), CPU, wavlm_path=wl)):
        with pytest.raises(ValueError) as e:
            make().reference_to_embedding(str(assets / "ref.wav"))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("seconds", [20.0, 2.5, 0.0])
def test_reference_workspace_estimate_matches_jax(pipes, seconds):
    jp, pp = pipes
    assert (pp.estimate_reference_workspace_bytes(seconds)
            == jp.estimate_reference_workspace_bytes(seconds))
    assert pp.wavlm.estimate_ssl_frames(24000, seconds) == jp.wavlm.estimate_ssl_frames(
        24000, seconds)


# -- the reference graphs (M8.1) --------------------------------------------------------

@pytest.fixture
def graphed(assets, monkeypatch):
    """A port pipeline whose reference chain takes the CUDA path's graph
    policy on the CPU: a stand-in graph (tests/test_torch_codec_graph.py)
    runs the chain on its own static buffers where a replay would run the
    captured kernels."""
    from miotts_tpu_torch.models import codec_graph
    from test_torch_codec_graph import _EagerCodecGraph

    monkeypatch.setattr(codec_graph, "CodecGraph", _EagerCodecGraph)
    pipe = MioTTSPipeline(str(assets / "codec.gguf"), CPU, wavlm_path=str(assets / "wavlm.gguf"))
    pipe.use_graph = True
    return pipe


def test_reference_graph_key_is_the_bucket(assets, pipes, graphed):
    """ref.wav (16 000 samples at 16 kHz) and ref.flac (14 400) share WavLM
    bucket 16 000 and so its one graph: the first chain eager, the second
    (the other length) the capture and its replay, the rest replays, each
    bit-equal to the eager pipeline's embedding of its file, as is the
    chain asked for eagerly by name (``reference_embedding_eager``); the graph is
    made in the reference graphs' pool (not the codec graphs') with a
    warm-up of its own (the capturing thread may not be the one that ran
    the eager chain), on the bucket's table, and counts into the reference
    counters alone."""
    from miotts_tpu_torch.models import codec_graph

    _, eager = pipes
    codec0, ref0 = (dataclasses.replace(c) for c in (codec_graph.codec, codec_graph.reference))
    order = ["ref.wav", "ref.flac", "ref.wav", "ref.flac", "ref.wav"]
    routes = []
    for name in order:
        got, stats = graphed.reference_embedding(str(assets / name))
        want, want_stats = eager.reference_embedding(str(assets / name))
        assert got.tobytes() == want.tobytes() and stats.bucket == 16000
        assert want_stats.route == "eager" and stats.rung == "ssl"
        routes.append(stats.route)
    assert routes == ["eager", "capture", "replay", "replay", "replay"]
    (bucket, graph), = graphed.ref_graphs.items()
    assert bucket == 16000 and graphed.ref_seen == {16000} and graph.n_replays == 4
    # the chain by name, eagerly beside its graph (a replay's reference)
    for name in ("ref.wav", "ref.flac"):
        assert (graphed.reference_embedding_eager(str(assets / name)).tobytes()
                == eager.reference_to_embedding(str(assets / name)).tobytes())
    assert graph.n_replays == 4
    assert graph.warm_up and graph.counters is codec_graph.reference
    assert graph.pool is graphed.ref_graph_pool and not graphed.graphs
    assert set(graph.inputs) == {"wav", "lengths", "buckets"}
    frames = graphed.wavlm.config.conv_out_len(16000)
    assert graph.inputs["buckets"] is graphed.wavlm.bucket_table(frames)[1]
    assert codec_graph.codec == codec0  # a run's host time counts as a reference replay's
    assert codec_graph.reference.replay_ms > ref0.replay_ms


def test_reference_chain_stays_eager_on_cpu(assets):
    """Without the CUDA path every chain runs eagerly: no graph, no count."""
    from miotts_tpu_torch.models import codec_graph

    pipe = MioTTSPipeline(str(assets / "codec.gguf"), CPU, wavlm_path=str(assets / "wavlm.gguf"))
    ref0 = dataclasses.replace(codec_graph.reference)
    routes = [pipe.reference_embedding(str(assets / n))[1].route
              for n in ("ref.wav", "ref.flac", "ref.wav")]
    assert routes == ["eager"] * 3 and not pipe.ref_graphs and pipe.ref_graph_pool is None
    assert codec_graph.reference == ref0


def test_parallel_reference_chains_share_a_graph(assets, pipes, graphed):
    """Four threads run chains of two lengths in one bucket at once, over
    and over, on one graph whose buffers each run rewrites: the lock holds
    copy-in, run and read together, so each gets its own eager result."""
    import threading

    _, eager = pipes
    want = {n: eager.reference_to_embedding(str(assets / n)) for n in ("ref.wav", "ref.flac")}
    graphed.reference_to_embedding(str(assets / "ref.wav"))  # the bucket's eager chain
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    bad, start = [], threading.Barrier(4, timeout=60)

    def worker(name):
        start.wait()
        for _ in range(3):
            got = graphed.reference_to_embedding(str(assets / name))
            if got.tobytes() != want[name].tobytes():
                bad.append(name)

    try:
        threads = [threading.Thread(target=worker, args=(n,))
                   for n in ("ref.wav", "ref.flac") * 2]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not bad
    assert len(graphed.ref_graphs) == 1 and graphed.ref_graphs[16000].n_replays == 12


# -- reference-audio decoding ----------------------------------------------------------

WAV_CASES = {"pcm8": dict(bits=8), "pcm16": dict(bits=16), "pcm24": dict(bits=24),
             "pcm32": dict(bits=32), "float32": dict(bits=32, fmt=3),
             "float64": dict(bits=64, fmt=3), "extensible24": dict(bits=24, extensible=True)}


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("case", sorted(WAV_CASES))
def test_load_audio_wav_bit_equal(tmp_path, case, channels):
    p = tmp_path / "x.wav"
    p.write_bytes(_wav_bytes(_tone(22050, 0.4, 4, channels), 22050, **WAV_CASES[case]))
    for kw in ({}, {"target_rate": 24000, "max_seconds": 0.3}, {"target_rate": 16000}):
        x, r = audio_io.load_audio(p, **kw)
        y, s = jax_audio.load_audio(p, **kw)
        assert r == s and x.dtype == y.dtype == np.float32 and np.array_equal(x, y), kw


@pytest.mark.parametrize("src,dst", [(24000, 16000), (44100, 16000), (16000, 24000),
                                     (8000, 8000), (22050, 16000)])
def test_resample_linear_bit_equal(src, dst):
    x = _tone(src, 0.37, 5)
    np.testing.assert_array_equal(audio_io.resample_linear(x, src, dst),
                                  jax_audio.resample_linear(x, src, dst))


def test_mp3_info_matches_jax():
    tag = b"ID3\x04\x00\x00\x00\x00\x00\x0a" + b"\x00" * 10
    cases = [tag + bytes([0xFF, 0xFB, 0x90, 0x00]), bytes([0xFF, 0xF3, 0x44, 0xC0]),
             b"\x00" * 64, b"xx" + bytes([0xFF, 0xE3, 0x18, 0x40])]
    cases += [Path(p).read_bytes() for p in MP3_FIXTURES]
    for data in cases:
        assert audio_io._mp3_info(data) == jax_audio._mp3_info(data)


def _mono16(n, seed, sr=16000):
    rng = np.random.RandomState(seed)
    x = 8000 * np.sin(2 * np.pi * 440 * np.arange(n) / sr) + rng.randn(n) * 300
    return np.clip(x, -32768, 32767).astype(np.int64)


FLAC_CASES = {
    "constant": lambda: encode_flac(np.full(9000, -1234, np.int64), 16000,
                                    subframe_kind="constant"),
    "verbatim": lambda: encode_flac(_mono16(9000, 1), 16000, subframe_kind="verbatim"),
    "fixed2": lambda: encode_flac(_mono16(9000, 1), 16000, subframe_kind="fixed2"),
    "lpc2": lambda: encode_flac(_mono16(9000, 1), 16000, subframe_kind="lpc2"),
    "mid_side": lambda: encode_flac(np.stack([_mono16(10000, 2, 22050),
                                              np.roll(_mono16(10000, 2, 22050), 7)], 1),
                                    22050, subframe_kind="fixed2", channel_mode="mid_side",
                                    partition_order=2),
    "left_side_escape": lambda: encode_flac(np.stack([_mono16(5000, 3), _mono16(5000, 4)], 1),
                                            16000, subframe_kind="fixed2",
                                            channel_mode="left_side", partition_order=2,
                                            escape_parts={1, 3}),
    "wasted": lambda: encode_flac((_mono16(5000, 3) >> 2) << 2, 16000, subframe_kind="fixed1",
                                  wasted=2),
}


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_flac_copy_bit_equal(case):
    data = FLAC_CASES[case]()
    x, r = flac.decode_flac(data)
    y, s = jax_flac.decode_flac(data)
    assert r == s and np.array_equal(x, y)


def _first_frame(data: bytes) -> tuple[int, int]:
    """(frame length, samples) of the stream's first mp3 frame."""
    fr_pos = next(i for i in range(len(data) - 1)
                  if data[i] == 0xFF and (data[i + 1] & 0xE0) == 0xE0)
    h1, h2 = data[fr_pos + 1], data[fr_pos + 2]
    version = (h1 >> 3) & 3
    v1 = version == 3
    rate = mp3.SAMPLE_RATES[version][(h2 >> 2) & 3]
    bitrate = (mp3.BITRATES_V1 if v1 else mp3.BITRATES_V2)[(h2 >> 4) & 15] * 1000
    return (144 if v1 else 72) * bitrate // rate + ((h2 >> 1) & 1), 1152 if v1 else 576


def _tagged(data: bytes, tag: bytes) -> bytes:
    """The stream with a VBR header frame in front: the first frame's
    header, zero side info (so JAX's decoder makes one frame of silence
    of it) and ``tag`` at its main data (Xing, Info) or 32 bytes after the
    header (VBRI)."""
    n, _ = _first_frame(data)
    frame = bytearray(n)
    frame[:4] = data[:4]
    at = 36 if tag == b"VBRI" else 4 + {3: (17, 32)}.get((data[1] >> 3) & 3, (9, 17))[
        ((data[3] >> 6) & 3) != 3]
    frame[at:at + 4] = tag
    return bytes(frame) + data


def _mp3_cases():
    cases = {f"lame{r}": (r, 1) for r in (44100, 24000, 11025)}
    cases["lame44100_joint_stereo"] = (44100, 2)
    return cases


@needs_oracles
@pytest.mark.parametrize("case", sorted(_mp3_cases()))
def test_mp3_copy_bit_equal(case):
    rate, nch = _mp3_cases()[case]
    pcm = _tone(rate, 0.8, 6, channels=nch)
    data = lame_encode(pcm, rate, nch=nch, bitrate=96 if rate > 24000 else 48)
    x, r = mp3.decode_mp3(data)
    y, s = jax_mp3.decode_mp3(data)
    assert r == s and np.array_equal(x, y)


@pytest.mark.skipif(not MP3_FIXTURES, reason="no mp3 fixture in image")
@pytest.mark.parametrize("i", range(len(MP3_FIXTURES)))
def test_mp3_copy_on_real_fixtures(i):
    """A real file decodes as the original does, less a leading VBR
    header frame where the file has one."""
    data = Path(MP3_FIXTURES[i]).read_bytes()
    x, r = mp3.decode_mp3(data)
    y, s = jax_mp3.decode_mp3(data)
    first = next(mp3._parse_frames(data))
    skip = (1152 if first.version == 3 else 576) if first.tag else 0
    assert r == s and np.array_equal(x, y[skip:])


@needs_oracles
@pytest.mark.parametrize("tag", [b"Xing", b"Info", b"VBRI"])
@pytest.mark.parametrize("rate", [44100, 22050])
def test_mp3_skips_vbr_header_frame(tag, rate):
    """A first frame carrying a Xing/Info/VBRI tag is not decoded: the
    port's output is the JAX decoder's less that frame's samples (1 152 at
    MPEG-1, 576 at MPEG-2), and equals the untagged stream's decode."""
    data = lame_encode(_tone(rate, 0.6, 8), rate, bitrate=64)
    tagged = _tagged(data, tag)
    x, r = mp3.decode_mp3(tagged)
    y, s = jax_mp3.decode_mp3(tagged)
    _, n = _first_frame(data)
    assert r == s == rate and n == (1152 if rate == 44100 else 576)
    assert np.array_equal(x, y[n:]) and not y[:n].any()
    assert np.array_equal(x, mp3.decode_mp3(data)[0])
    assert not next(mp3._parse_frames(data)).tag


def test_undecodable_container(tmp_path, monkeypatch):
    """No torchaudio, no ffmpeg: the port's error names what it decodes."""
    monkeypatch.setitem(sys.modules, "torchaudio", None)
    monkeypatch.setattr("shutil.which", lambda _: None)
    p = tmp_path / "x.ogg"
    p.write_bytes(b"OggS" + bytes(200))
    with pytest.raises(ValueError, match="WAV, FLAC, and mp3 decode natively.*torchaudio "
                                         "or ffmpeg installed"):
        audio_io.load_audio(p)


# -- the CLI -----------------------------------------------------------------------------

def _cli_runs(argv_of, capsys):
    """The same command through the JAX CLI and the port's: [(rc, stderr
    lines without the port's breakdown lines)] and the paths named."""
    out = []
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        rc = main(argv_of(name))
        err = [l for l in capsys.readouterr().err.splitlines()
               if "breakdown:" not in l and not l.startswith("wrote ")]
        out.append((rc, [l.replace(f"/{name}.", "/X.") for l in err]))
    return out


def test_cli_reference_one_shot_matches_jax(assets, tmp_path, capsys, monkeypatch):
    """--tts-reference-audio + --tts-wavlm-model + --tts-mio-embedding-out
    with codes: the same embedding (1e-4), WAV (2 LSB) and stderr."""
    monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")

    def argv(name):
        return ["-mv", str(assets / "codec.gguf"), "--tts-wavlm-model",
                str(assets / "wavlm.gguf"), "--tts-reference-audio", str(assets / "ref.flac"),
                "--tts-mio-codes-in", str(assets / "codes.txt"),
                "--tts-mio-embedding-out", str(tmp_path / f"{name}.emb.gguf"),
                "-o", str(tmp_path / f"{name}.wav")]

    runs = _cli_runs(argv, capsys)
    assert runs[0] == runs[1] and runs[0][0] == 0
    a, b = (load_embedding_gguf(tmp_path / f"{n}.emb.gguf") for n in ("jax", "port"))
    assert np.abs(a - b).max() <= EMB_TOL
    wa, wb = ((tmp_path / f"{n}.wav").read_bytes() for n in ("jax", "port"))
    assert wa[:44] == wb[:44]
    diff = np.abs(np.frombuffer(wa[44:], "<i2").astype(int) - np.frombuffer(wb[44:], "<i2"))
    assert diff.max() <= 2


def test_cli_reference_breakdown_line(assets, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")
    rc = cli.main(["-mv", str(assets / "codec.gguf"), "--tts-wavlm-model",
                   str(assets / "wavlm.gguf"), "--tts-reference-audio", str(assets / "ref.wav"),
                   "--tts-mio-embedding-out", str(tmp_path / "e.gguf"),
                   "--tts-mio-embedding-only"])
    err = capsys.readouterr().err
    line = next(l for l in err.splitlines() if l.startswith("reference breakdown:"))
    fields = dict(kv.split("=") for kv in line.split(": ", 1)[1].split())
    assert rc == 0 and set(fields) == {"decode_ms", "device_ms", "bucket", "frames", "rung"}
    assert (fields["bucket"], fields["frames"], fields["rung"]) == ("16000", "799", "ssl")


CLI_CASES = {
    # name: (extra flags, files written)
    "embedding_only": (["--tts-mio-embedding-only", "--tts-mio-embedding-out", "{d}/{n}.emb"],
                       ["{n}.emb"]),
    "embedding_only_no_out": (["--tts-mio-embedding-only"], []),
    "reference_over_embedding_in": (["--tts-mio-embedding-in", "{a}/voice_a.emb.gguf",
                                     "-emb", "{a}/voice_b.emb.gguf", "--tts-mio-codes", "1 2 3",
                                     "-o", "{d}/{n}.wav"], ["{n}.wav"]),
    "no_wavlm_model": (["--tts-mio-codes", "1 2 3", "-o", "{d}/{n}.wav"], []),
    "bad_reference": (["--tts-mio-codes", "1 2 3"], []),
    "embedding_only_without_reference": (["--tts-mio-embedding-only"], []),
    "no_global_encoder": (["--tts-mio-codes", "1 2 3"], []),
    "missing_wavlm_file": (["--tts-mio-codes", "1 2 3"], []),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_flags_match_jax(assets, tmp_path, capsys, monkeypatch, case):
    """Exit codes, stderr (less the port's breakdown lines) and the files
    written, as the JAX CLI's."""
    monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")
    extra, files = CLI_CASES[case]
    codec = "codec_noge.gguf" if case == "no_global_encoder" else "codec.gguf"

    def argv(name):
        a = ["-mv", str(assets / codec)]
        if case != "no_wavlm_model":
            a += ["--tts-wavlm-model", str(tmp_path / "none.gguf") if case == "missing_wavlm_file"
                  else str(assets / "wavlm.gguf")]
        if case not in ("embedding_only_without_reference",):
            a += ["--tts-reference-audio",
                  str(tmp_path / "no.wav") if case == "bad_reference" else str(assets / "ref.wav")]
        return a + [x.format(d=tmp_path, a=assets, n=name) for x in extra]

    runs = _cli_runs(argv, capsys)
    assert runs[0] == runs[1]
    for f in files:
        for name in ("jax", "port"):
            assert (tmp_path / f.format(n=name)).exists()
    if case == "embedding_only":
        a, b = (load_embedding_gguf(tmp_path / f"{n}.emb") for n in ("jax", "port"))
        assert np.abs(a - b).max() <= EMB_TOL
    if case == "reference_over_embedding_in":
        wa, wb = ((tmp_path / f"{n}.wav").read_bytes() for n in ("jax", "port"))
        diff = np.abs(np.frombuffer(wa[44:], "<i2").astype(int) - np.frombuffer(wb[44:], "<i2"))
        assert wa[:44] == wb[:44] and diff.max() <= 2


# -- the server --------------------------------------------------------------------------

def _server_config(cls, d: Path, out: str, **kw):
    return cls(model_vocoder=str(d / "codec.gguf"), model="", host="127.0.0.1", port=0,
               wavlm_model=str(d / "wavlm.gguf"), n_parallel=2,
               n_parallel_reference_generation=2, output_dir=str(d / out),
               reference_added_output_dir=str(d / f"{out}_refs"), **kw)


@pytest.fixture(scope="module")
def servers(assets):
    port = MioTTSServer(_server_config(ServerConfig, assets, "port_out"), CPU)
    ref = JaxServer(_server_config(JaxServerConfig, assets, "jax_out"))
    for s in (port, ref):
        s.start_background()
    yield port, ref
    for s in (port, ref):
        s.shutdown()


def _post(srv, path: str, body: bytes, ctype: str):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _multipart(fields: dict, files: dict) -> tuple[bytes, str]:
    boundary = uuid.uuid4().hex
    parts = []
    for k, v in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n'
                     f"{v}\r\n".encode())
    for k, (fname, data) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; '
                     f'filename="{fname}"\r\nContent-Type: application/octet-stream\r\n\r\n'
                     .encode() + data + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), \
        f"multipart/form-data; boundary={boundary}"


def _emb_of(payload: bytes, tmp_path: Path) -> np.ndarray:
    p = tmp_path / f"{uuid.uuid4().hex}.gguf"
    p.write_bytes(payload)
    return load_embedding_gguf(p)


def _gen_ref_request(assets, case):
    if case == "json":
        return json.dumps({"reference_key": "c_json",
                           "reference_audio": str(assets / "ref.wav")}).encode(), \
            "application/json"
    if case == "json_alias_and_seconds":
        return json.dumps({"reference_key": "c_alias", "max_reference_seconds": 0.5,
                           "tts_reference_audio": str(assets / "ref.flac")}).encode(), \
            "application/json"
    if case == "multipart":
        return _multipart({"reference_key": "c_up", "max_reference_seconds": "0.75"},
                          {"audio": ("clip.wav", (assets / "ref44_stereo.wav").read_bytes())})
    bad = {"invalid_key": ({"reference_key": "a/b", "reference_audio": "x.wav"}, None),
           "missing_audio": ({"reference_key": "k"}, None),
           "undecodable_audio": ({"reference_key": "k",
                                  "reference_audio": str(assets / "codes.txt")}, None),
           "missing_file": ({"reference_key": "k", "reference_audio": "/no/such.wav"}, None),
           "multipart_bad_seconds": ({"reference_key": "k", "max_reference_seconds": "x"},
                                     {"audio": ("a.wav", b"RIFF")}),
           "multipart_no_audio": ({"reference_key": "k"}, {})}[case]
    if case.startswith("multipart"):
        return _multipart(*bad)
    return json.dumps(bad[0]).encode(), "application/json"


@pytest.mark.parametrize("case", ["json", "json_alias_and_seconds", "multipart", "invalid_key",
                                  "missing_audio", "undecodable_audio", "missing_file",
                                  "multipart_bad_seconds", "multipart_no_audio"])
def test_generate_reference_matches_jax_server(assets, servers, tmp_path, case):
    """/mio/generate_reference (and its /v1 alias) on both servers: the
    status, the error JSON, the attachment headers, and the embedding
    within 1e-4; the upload is removed and the key is usable."""
    body, ctype = _gen_ref_request(assets, case)
    path = "/v1/audio/generate_reference" if case == "multipart" else "/mio/generate_reference"
    got, ref = (_post(s, path, body, ctype) for s in servers)
    assert got[0] == ref[0], (got, ref)
    if ref[0] != 200:
        # the port words an undecodable container for the decoders it has
        want = ref[2].decode().replace("torchaudio, pygame, or ffmpeg", "torchaudio or ffmpeg")
        assert json.loads(got[2]) == json.loads(want)
        return
    keys = ("Content-Type", "Content-Disposition", "X-Reference-Key", "X-Embedding-Dim")
    assert {k: got[1][k] for k in keys} == {k: ref[1][k] for k in keys}
    assert got[1]["X-Reference-Saved-Path"].replace("port_out", "jax_out") == \
        ref[1]["X-Reference-Saved-Path"]
    a, b = _emb_of(got[2], tmp_path), _emb_of(ref[2], tmp_path)
    assert np.abs(a - b).max() <= EMB_TOL
    assert np.array_equal(load_embedding_gguf(got[1]["X-Reference-Saved-Path"]), a)
    port = servers[0]
    key = got[1]["X-Reference-Key"]
    assert np.array_equal(port.engine.ref_cache.get(key), a)
    assert not list((assets / "port_out").glob("mio-upload-*"))
    assert port.engine.ref_gen_inflight == 0
    status, _, wav = _post(port, "/mio/tts/stream",
                           json.dumps({"codes": [1, 2, 3, 4], "reference_key": key}).encode(),
                           "application/json")
    assert status == 200 and wav[:4] == b"RIFF"


def test_health_reports_reference_generation(servers):
    for srv in servers:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/mio/health", timeout=30) as r:
            j = json.loads(r.read())
        assert j["reference_generation_enabled"] is True
        assert j["reference_generation_initialized"] is True
        assert j["parallel_reference_generation"] == 2
        assert j["reference_generation_inflight"] == 0


def test_concurrent_reference_generations(assets, servers, tmp_path):
    """Two generations at once on two reference slots: both succeed and
    give the one-at-a-time embedding."""
    import concurrent.futures

    port = servers[0]
    body, ctype = _gen_ref_request(assets, "json")
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        res = list(ex.map(lambda _: _post(port, "/mio/generate_reference", body, ctype),
                          range(2)))
    assert [r[0] for r in res] == [200, 200]
    a, b = (_emb_of(r[2], tmp_path) for r in res)
    assert np.array_equal(a, b)


# -- the embeddable engine -----------------------------------------------------------------

def test_key_from_path():
    for p in ("/a/b/jp_female.emb.gguf", "voice.gguf", "clip.wav"):
        assert embed._key_from_path(p) == jax_embed._key_from_path(p)


def test_engine_register_and_synthesize_codes(assets):
    eng = embed.MioTTSEngine(str(assets / "codec.gguf"), device=CPU)
    ref = jax_embed.MioTTSEngine(str(assets / "codec.gguf"))
    keys = eng.register_default_references(str(assets))
    assert keys == ref.register_default_references(str(assets)) == ["voice_a", "voice_b"]
    assert eng.default_reference_key == "voice_a"
    for key in (None, "voice_b"):
        wav, want = (e.synthesize_codes_to_wav(list(range(12)), reference_key=key)
                     for e in (eng, ref))
        assert wav[:44] == want[:44]
        assert np.abs(np.frombuffer(wav[44:], "<i2").astype(int)
                      - np.frombuffer(want[44:], "<i2")).max() <= 2
    with pytest.raises(KeyError):
        eng.synthesize_codes_to_wav([1, 2], reference_key="missing")


def test_engine_text_to_wav_lazy_llm_and_unload(assets):
    eng = embed.MioTTSEngine(str(assets / "codec.gguf"), llm_model=str(assets / "llm.gguf"),
                             n_predict=12, llm_unload_after_generation=True, device=CPU)
    eng.register_reference("v", str(assets / "voice_a.emb.gguf"))
    assert eng._llm is None
    assert eng.synthesize_text_to_wav("hello", reference_key="v")[:4] == b"RIFF"
    assert eng._llm is None  # unloaded after generation
    no_llm = embed.MioTTSEngine(str(assets / "codec.gguf"), device=CPU)
    no_llm.register_reference("v", str(assets / "voice_a.emb.gguf"))
    with pytest.raises(ValueError, match="LLM model path is not configured"):
        no_llm.synthesize_text_to_wav("hello")


def test_engine_voice_clone_roundtrip(assets):
    eng = embed.MioTTSEngine(str(assets / "codec.gguf"), wavlm_model=str(assets / "wavlm.gguf"),
                             device=CPU)
    ref = jax_embed.MioTTSEngine(str(assets / "codec.gguf"),
                                 wavlm_model=str(assets / "wavlm.gguf"))
    emb = eng.create_reference_from_audio("cloned", str(assets / "ref.wav"))
    want = ref.create_reference_from_audio("cloned", str(assets / "ref.wav"))
    assert emb.shape == (CODEC.decoder_adanorm_dim,) and np.abs(emb - want).max() <= EMB_TOL
    assert eng.default_reference_key == "cloned"
    assert eng.synthesize_codes_to_wav([3, 4, 5, 6], reference_key="cloned")[:4] == b"RIFF"
    assert eng.remove_reference("cloned")
    assert not eng.remove_reference("cloned")


def test_engine_static_codec_needs_no_reference(assets):
    eng = embed.MioTTSEngine(str(assets / "codec_static.gguf"), device=CPU)
    assert eng._resolve_embedding(None) is None
    assert eng.synthesize_codes_to_wav([1, 2, 3])[:4] == b"RIFF"
