"""Mel mode of the port against the JAX package, on the CPU.

The plain versions of kernels K4 (conv1d), K5 (anti-aliased snake) and K6
(fused resblock layer) are held against the JAX Pallas kernels run in
interpret mode and against JAX's XLA composites, at the shapes of the JAX
package's own tests (tests/test_vocoder.py, tests/test_resblock_fused.py)
and with their tolerances: K4 rtol = atol = 1e-5, K5 rtol 1e-5 / atol
2e-6, K6 max abs 2e-5 (f32 sums in another order). Then the vocoder
forward, mel-mode codec synthesis and the CLI on a tiny mel GGUF.
"""

import dataclasses
import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miotts_tpu import cli as jax_cli
from miotts_tpu.models import vocoder as JV
from miotts_tpu.models.miocodec import codec_synthesize as jax_synthesize
from miotts_tpu.models.miocodec import load_miocodec as jax_load
from miotts_tpu.ops.masking import mask_time as jax_mask_time
from miotts_tpu.ops.pallas.activation1d import fused_activation1d
from miotts_tpu.ops.pallas.conv1d import conv1d_same_pallas
from miotts_tpu.ops.pallas.resblock import fused_resblock_layer
from miotts_tpu_torch import cli
from miotts_tpu_torch.convert import miocodec_params_from_jax
from miotts_tpu_torch.models import vocoder as V
from miotts_tpu_torch.models.miocodec import codec_synthesize, load_miocodec
from miotts_tpu_torch.ops.cuda import activation1d as k5
from miotts_tpu_torch.ops.cuda import conv1d as k4
from miotts_tpu_torch.ops.cuda import resblock as k6
from miotts_tpu_torch.testing import (
    save_embedding_gguf, tiny_codec_config, write_synthetic_mel_vocoder_gguf)

torch.set_num_threads(1)
CPU = torch.device("cpu")
MEL_CFG = dict(model_type=1, n_mels=12, n_fft=64, hop_length=16, samples_per_token=32,
               resnet_blocks=0, vocoder_upsample_rates=(4, 2, 2), vocoder_num_kernels=2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _hann_filter(k, scale=1.0):
    f = np.hanning(k + 2)[1:-1].astype(np.float32)
    return (f / f.sum() * scale).astype(np.float32)


@pytest.mark.parametrize("cin,cout,k,d,res", [
    (16, 24, 3, 1, False), (16, 16, 3, 5, True), (32, 32, 7, 1, True),
])
def test_conv1d_plain_matches_jax(cin, cout, k, d, res):
    rng = np.random.RandomState(cin + k + d)
    B, T = 2, 300
    lengths = np.asarray([T, rng.randint(1, T)], np.int32)
    x = np.asarray(jax_mask_time(jnp.asarray(rng.randn(B, T, cin).astype(np.float32)),
                                 jnp.asarray(lengths)))
    w = (rng.randn(cout, cin, k) * 0.1).astype(np.float32)
    b = (rng.randn(cout) * 0.05).astype(np.float32)
    r = (np.asarray(jax_mask_time(jnp.asarray(rng.randn(B, T, cout).astype(np.float32)),
                                  jnp.asarray(lengths))) if res else None)
    got = k4.conv1d_same(_t(x), torch.from_numpy(lengths), _t(w), _t(b), d,
                         None if r is None else _t(r)).numpy()
    pallas = conv1d_same_pallas(jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(w),
                                jnp.asarray(b), d, residual=None if r is None else jnp.asarray(r),
                                block_t=64, interpret=True)
    xla = JV.conv1d_same(jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(w), jnp.asarray(b),
                         d, residual=None if r is None else jnp.asarray(r), impl="xla")
    for ref in (pallas, xla):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert np.all(got[1, lengths[1]:] == 0)


# the vocoder's K4 shapes: stage 1 of a 40-code request (the short route),
# stage 1 of a 400-code one, a ragged pair, the last stage; and odd sizes
@pytest.mark.parametrize("B,T,Cout", [(1, 640, 128), (1, 5120, 128), (2, 2560, 128),
                                      (1, 491520, 128), (3, 37, 20), (1, 1, 4)])
def test_conv1d_launch_shape(B, T, Cout):
    """Kernel K4's grid covers every (example, row, column) of the output
    exactly once; the short route's 640 rows give every SM of the H100 a
    block (>= 132), and the last stage keeps the largest tile."""
    tile, tm, tn, grid = k4.launch_shape(B, T, Cout)
    assert (tm, tn) == k4.TILES[tile]
    # the grid is a product: rows by grid x, examples by grid y, columns by z
    for n, size, extent in ((grid[0], tm, T), (grid[1], 1, B), (grid[2], tn, Cout)):
        hits = np.zeros(n * size, np.int64)
        for i in range(n):
            hits[i * size:(i + 1) * size] += 1
        assert (hits[:extent] == 1).all() and (n - 1) * size < extent
    blocks = int(np.prod(grid))
    if (B, T) == (1, 640):
        assert blocks >= 132
    if T == 491520:
        assert tile == 0
    assert blocks >= 132 or tile == len(k4.TILES) - 1


def _act_reach(k1, k2):
    """(rows below, rows above) an Activation1d output row reads, by brute
    force over the composite's index arithmetic (models/vocoder.py): output t
    reads 2x samples 2t - pl2 + j (j < k2) and the one before each; 2x
    sample u reads input rows (u + pl - m) / 2 - pad for the taps m < k1
    of u + pl's parity."""
    pad, pl2 = k1 // 2 - 1, k2 // 2 - (1 if k2 % 2 == 0 else 0)
    pl = 2 * pad + (k1 - 2) // 2
    t = 100
    rows = [(u + pl - m) // 2 - pad
            for j in range(k2) for u in (2 * t - pl2 + j, 2 * t - pl2 + j - 1)
            for m in range(k1) if (u + pl - m) % 2 == 0]
    return t - min(rows), max(rows) - t


# the JAX package's production bound for the fused layer (resblock.py:13-17):
# filters up to 24 taps, dilation up to 5, k = 3
@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("taps_a,taps_b", [((12, 12), (12, 12)), ((24, 24), (24, 24)),
                                           ((12, 24), (24, 12)), ((16, 20), (13, 17))])
def test_resblock_launch_shape(d, taps_a, taps_b):
    """Kernel K6's tile plan at C = 128: the staged input window covers the
    halo that telescopes through conv2, actB, conv1 and actA; conv1's rows
    cover what actB reads; the buffers fit the 227 KB of shared memory a
    block may have; and the halo work redone by each tile (actA's rows and
    conv1's rows per output row) stays below the 1.45 of 51-row tiles."""
    C, k, T = 128, 3, 491520
    p = k6.launch_shape(1, T, C, k, d, k, taps_a, taps_b)
    (loA, hiA), (loB, hiB) = _act_reach(*taps_a), _act_reach(*taps_b)
    assert (k6.act_geom(*taps_a).hlo, k6.act_geom(*taps_a).hhi) == (loA, hiA)
    half1, half2 = (k - 1) // 2 * d, (k - 1) // 2
    # rows relative to the tile's first output row, outermost last
    conv2_in = (-half2, p.n_out - 1 + half2)
    conv1_out = (conv2_in[0] - loB, conv2_in[1] + hiB)
    conv1_in = (conv1_out[0] - half1, conv1_out[1] + half1)
    x_in = (conv1_in[0] - loA, conv1_in[1] + hiA)
    assert -p.halo_lo <= x_in[0] and x_in[1] < -p.halo_lo + p.window
    assert conv1_out[1] - conv1_out[0] + 1 <= p.tm1 and p.n_out <= p.tm2
    assert p.act_a_rows >= p.tm1 + 2 * half1 and p.window <= p.rows_in
    assert p.smem <= k6.MAX_SMEM == 227 * 1024
    assert p.act_a_rows / p.n_out < 1.45 and p.tm1 / p.n_out < 1.45
    assert p.grid == (-(-T // p.n_out), 1)


@pytest.mark.parametrize("k1,k2,T,C,B,bt", [
    (12, 12, 300, 16, 3, 64),   # even/even, ragged lengths, multi-tile
    (13, 15, 97, 8, 2, 64),     # odd filters, non-dividing T
    (16, 12, 520, 24, 2, 256),  # asymmetric filter pair
])
def test_activation1d_plain_matches_jax(k1, k2, T, C, B, bt):
    rng = np.random.RandomState(k1 + k2)
    f1, f2 = _hann_filter(k1), _hann_filter(k2)
    lengths = rng.randint(1, T + 1, B).astype(np.int32)
    lengths[0] = T
    x = np.asarray(jax_mask_time(jnp.asarray(rng.randn(B, T, C).astype(np.float32)),
                                 jnp.asarray(lengths)))
    alpha = (rng.randn(C) * 0.1).astype(np.float32)
    beta = (rng.randn(C) * 0.1).astype(np.float32)
    got = k5.activation1d(_t(x), torch.from_numpy(lengths), _t(f1), _t(alpha), _t(beta),
                          _t(f2)).numpy()
    args = (jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(f1), jnp.asarray(alpha),
            jnp.asarray(beta), jnp.asarray(f2))
    pallas, _ = fused_activation1d(*args, block_t=bt, interpret=True)
    act = {"up_filter": args[2], "alpha": args[3], "beta": args[4], "down_filter": args[5]}
    xla, _ = JV.activation1d(args[0], args[1], act, impl="xla")
    for ref in (pallas, xla):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=2e-6)
    for b in range(B):
        assert np.all(got[b, lengths[b]:] == 0)


def _layer_operands(rng, B, T, C, k_conv=3):
    """The JAX resblock test's operands (tests/test_resblock_fused.py:15-34)."""
    def act():
        f = _hann_filter(12)
        return {"alpha": (rng.randn(C) * 0.2).astype(np.float32),
                "beta": (rng.randn(C) * 0.2).astype(np.float32),
                "up_filter": f, "down_filter": (f * 0.9).astype(np.float32)}

    x = (rng.randn(B, T, C) * 0.4).astype(np.float32)
    actA, actB = act(), act()
    w1 = (rng.randn(C, C, k_conv) * 0.05).astype(np.float32)
    b1 = (rng.randn(C) * 0.1).astype(np.float32)
    w2 = (rng.randn(C, C, k_conv) * 0.05).astype(np.float32)
    b2 = (rng.randn(C) * 0.1).astype(np.float32)
    return x, actA, actB, w1, b1, w2, b2


def _port_layer(x, lengths, actA, w1, b1, dil, actB, w2, b2):
    tA, tB = ({k: _t(v) for k, v in a.items()} for a in (actA, actB))
    return k6.resblock_layer(_t(x), torch.as_tensor(lengths), tA, _t(w1), _t(b1), dil, tB,
                             _t(w2), _t(b2)).numpy()


@pytest.mark.parametrize("dil,pallas", [(1, False), (3, False), (5, True)])
def test_resblock_plain_matches_jax(dil, pallas):
    rng = np.random.RandomState(dil)
    B, T, C = 2, 1100, 32
    x, actA, actB, w1, b1, w2, b2 = _layer_operands(rng, B, T, C)
    lengths = np.asarray([T, T - 333], np.int32)
    x = np.asarray(jax_mask_time(jnp.asarray(x), jnp.asarray(lengths)))
    got = _port_layer(x, lengths, actA, w1, b1, dil, actB, w2, b2)
    jA, jB = ({k: jnp.asarray(v) for k, v in a.items()} for a in (actA, actB))
    jargs = (jnp.asarray(x), jnp.asarray(lengths), jA, jnp.asarray(w1), jnp.asarray(b1), dil,
             jB, jnp.asarray(w2), jnp.asarray(b2))
    rb = {"acts": [jA, jB] * 3, "convs1": [{"w": jargs[3], "b": jargs[4]}] * 3,
          "convs2": [{"w": jargs[7], "b": jargs[8]}] * 3}
    refs = [JV._resblock_layer(jargs[0], jargs[1], rb, 0, dil, impl="xla")]
    if pallas:
        refs.append(fused_resblock_layer(*jargs, interpret=True))
    for ref in refs:
        assert np.abs(got - np.asarray(ref)).max() < 2e-5
    assert np.all(got[1, lengths[1]:] == 0)


def test_resblock_plain_padded_bucket():
    """The same signal in a bucket 480 rows longer gives the same valid rows
    and zeros beyond. torch's CPU convolutions do not promise bit-equality
    across shapes (the JAX test asserts it for the kernel), so 1e-6."""
    rng = np.random.RandomState(7)
    B, T, C = 1, 1200, 32
    x, actA, actB, w1, b1, w2, b2 = _layer_operands(rng, B, T, C)
    lengths = np.asarray([T], np.int32)
    y1 = _port_layer(x, lengths, actA, w1, b1, 3, actB, w2, b2)
    y2 = _port_layer(np.pad(x, ((0, 0), (0, 480), (0, 0))), lengths, actA, w1, b1, 3, actB,
                     w2, b2)
    np.testing.assert_allclose(y2[:, :T], y1, rtol=0, atol=1e-6)
    assert np.all(y2[:, T:] == 0.0)


@pytest.fixture(scope="module")
def mel_model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mel") / "mel_vocoder.gguf")
    write_synthetic_mel_vocoder_gguf(path, tiny_codec_config(**MEL_CFG), seed=0)
    jcfg, jw = jax_load(path)
    return path, jcfg, jw


def test_mel_config_and_weights_load(mel_model):
    path, jcfg, jw = mel_model
    cfg, w = load_miocodec(path, CPU)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.model_type == 1 and cfg.has_vocoder and "prior" not in w
    assert w["mel_postnet"]["conv_w"].shape == (2, 12, 12, 5)
    _, wj = miocodec_params_from_jax(jcfg, jw, CPU)
    flat, flat_j = (jax.tree_util.tree_leaves(t) for t in (w["vocoder"], wj["vocoder"]))
    assert len(flat) == len(flat_j) and all(torch.equal(a, b) for a, b in zip(flat, flat_j))


@pytest.mark.parametrize("T,padded", [(9, 9), (7, 16)])
def test_vocoder_decode_matches_jax(mel_model, T, padded):
    _, jcfg, jw = mel_model
    cfg, w = miocodec_params_from_jax(jcfg, jw, CPU)
    mel = np.zeros((1, padded, cfg.n_mels), np.float32)
    mel[:, :T] = (np.random.RandomState(T).randn(1, T, cfg.n_mels) * 0.5).astype(np.float32)
    lengths = np.asarray([T], np.int32)
    audio, n = V.vocoder_decode(cfg, w, torch.from_numpy(mel), torch.from_numpy(lengths))
    ref, ref_n = jax.jit(lambda w, m, l: JV.vocoder_decode(jcfg, w, m, l))(
        jax.tree.map(jnp.asarray, jw), jnp.asarray(mel), jnp.asarray(lengths))
    k = int(ref_n[0])
    assert int(n[0]) == k == T * 16
    np.testing.assert_allclose(audio[0, :k].numpy(), np.asarray(ref)[0, :k], rtol=1e-4, atol=1e-5)
    assert np.all(audio[0, k:].numpy() == 0)


@pytest.fixture(scope="module")
def mel_synth_ref(mel_model):
    _, jcfg, jw = mel_model
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    lengths = np.asarray([16, 6], np.int32)
    cond = rng.randn(2, jcfg.decoder_adanorm_dim).astype(np.float32)
    ref, ref_n = jax.jit(functools.partial(jax_synthesize, jcfg))(
        jax.tree.map(jnp.asarray, jw), jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(cond))
    return tokens, lengths, cond, np.asarray(ref), np.asarray(ref_n)


@pytest.mark.parametrize("source", ["gguf", "jax_tree"])
def test_mel_synthesize_matches_jax(mel_model, mel_synth_ref, source):
    """Audio atol 1e-4, as the wave-mode test (tests/test_torch_miocodec.py)."""
    path, jcfg, jw = mel_model
    tokens, lengths, cond, ref, ref_n = mel_synth_ref
    cfg, w = load_miocodec(path, CPU) if source == "gguf" else miocodec_params_from_jax(
        jcfg, jw, CPU)
    audio, n = codec_synthesize(cfg, w, torch.from_numpy(tokens), torch.from_numpy(lengths),
                                torch.from_numpy(cond))
    assert np.array_equal(n.numpy(), ref_n)
    assert list(n.numpy()) == [cfg.stft_frames(16) * 16, cfg.stft_frames(6) * 16]
    np.testing.assert_allclose(audio.numpy(), ref, atol=1e-4, rtol=0)
    for b, k in enumerate(n.numpy()):
        a = audio[b].numpy()
        assert np.all(a[k:] == 0) and np.isfinite(a[:k]).all() and np.any(a[:k] != 0)


def test_mel_dispatch_follows_jax_conditions(mel_model, monkeypatch):
    """Which kernel each call site takes: K6 for every resblock layer at a
    padded length >= 1024 rows, else K5, K4, K5, K4; K4 for each stage's
    noise conv; K5 once after the last stage (the launch structure
    chip_smoke.py counts on the card)."""
    _, jcfg, jw = mel_model
    cfg, w = miocodec_params_from_jax(jcfg, jw, CPU)
    calls = {"k4": 0, "k5": 0, "k6": 0}
    for name, mod, fn in (("k4", k4, "conv1d_same"), ("k5", k5, "activation1d"),
                          ("k6", k6, "resblock_layer")):
        real = getattr(mod, fn)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, fn, spy)
    n_layers = 3 * cfg.vocoder_num_kernels  # resblock layers a stage
    for T in (20, 70):  # stage lengths 80/160/320 and 280/560/1120 rows
        calls.update(k4=0, k5=0, k6=0)
        V.vocoder_decode(cfg, w, torch.zeros(1, T, cfg.n_mels), torch.tensor([T]))
        n_fused = sum(T * r >= 1024 for r in (4, 8, 16))
        n_unfused = 3 - n_fused
        assert calls == {"k4": 3 + 2 * n_layers * n_unfused, "k5": 1 + 2 * n_layers * n_unfused,
                         "k6": n_layers * n_fused}, (T, calls)


def _wav(path):
    data = path.read_bytes()
    riff, size, wave, fmt, _, pcm, ch, sr, _, _, bits, tag, n = struct.unpack_from(
        "<4sI4s4sIHHIIHH4sI", data)
    assert (riff, wave, fmt, tag, pcm, ch, bits) == (b"RIFF", b"WAVE", b"fmt ", b"data", 1, 1, 16)
    assert size == 36 + n and len(data) == 44 + n
    return sr, np.frombuffer(data[44:], "<i2").astype(np.int32)


def test_mel_cli_codes_to_wav_matches_jax_cli(mel_model, tmp_path, monkeypatch):
    monkeypatch.setenv("MIOTTS_PLATFORM", "cpu")
    path, jcfg, _ = mel_model
    save_embedding_gguf(tmp_path / "voice.emb.gguf",
                        np.random.RandomState(0).randn(jcfg.decoder_adanorm_dim).astype(np.float32))
    codes = np.random.RandomState(1).randint(0, jcfg.vocab_size, 20)
    (tmp_path / "codes.txt").write_text("\n".join(map(str, codes)))
    base = ["-mv", path, "--tts-mio-codes-in", str(tmp_path / "codes.txt"),
            "-emb", str(tmp_path / "voice.emb.gguf")]
    assert cli.main(base + ["-o", str(tmp_path / "port.wav")]) == 0
    assert jax_cli.main(base + ["-o", str(tmp_path / "jax.wav")]) == 0
    sr, got = _wav(tmp_path / "port.wav")
    sr_j, ref = _wav(tmp_path / "jax.wav")
    assert sr == sr_j == 24000 and got.size == ref.size == jcfg.stft_frames(20) * 16
    assert np.abs(got - ref).max() <= 2 and np.abs(got).max() > 0
