"""The port's sequence parallelism (miotts_tpu_torch/parallel/sequence.py,
``--sequence-parallel``) on logical CPU ranks (MIOTTS_LOGICAL_DEVICES=8,
the counterpart of the JAX suite's 8 forced host devices).

Every case of tests/test_sequence_parallel.py, each held at atol 1e-4 on
audio (2 int16 steps through the CLI) against the JAX package's own sp
decode on its 8 forced CPU devices and against the port's mesh-less
decode: the mesh's shape, an oversized sp, the weights replicated by one
upload, sp = 2 and 8, the wave upsampler, ragged lengths whose masked
tail crosses a shard boundary, the window fetch, the CLI flag and mel
mode. Then each sharded op of ``parallel/sequence.py`` against its
mesh-less op at sp = 2, 3 and 8 (uneven splits, and ranks holding no
rows, among them), and a check that the sp decode calls the kernel
wrappers the mesh-less decode calls, as often, on every rank.
"""

import jax
import numpy as np
import pytest
import torch

from miotts_tpu.cli import main as jax_cli_main
from miotts_tpu.pipeline import MioTTSPipeline as JaxPipeline
from miotts_tpu_torch import cli
from miotts_tpu_torch.gguf.writer import save_embedding_gguf
from miotts_tpu_torch.models import miocodec, vocoder
from miotts_tpu_torch.ops.convs import conv1d_same, conv_transpose1d, linear_interpolate
from miotts_tpu_torch.ops.cuda import graphs
from miotts_tpu_torch.ops.istft import dft_tables, spec_to_audio
from miotts_tpu_torch.ops.masking import mask_time
from miotts_tpu_torch.ops.norms import masked_group_norm
from miotts_tpu_torch.ops.resample import conv1d_zeropad
from miotts_tpu_torch.parallel import sequence as seq
from miotts_tpu_torch.parallel.mesh import (
    LOGICAL_ENV, Device, SpMesh, logical_devices, make_sp_mesh)
from miotts_tpu_torch.pipeline import MioTTSPipeline
from miotts_tpu_torch.runtime.audio_io import load_audio
from miotts_tpu_torch.runtime.device_dequant import tree_to_device
from miotts_tpu_torch.testing import (
    tiny_codec_config, write_synthetic_mel_vocoder_gguf, write_synthetic_miocodec_gguf)

torch.set_num_threads(1)
CPU = torch.device("cpu")
# peak-normalized audio is O(1): JAX's own bar for an sp decode
ATOL = 1e-4
MEL_CFG = dict(model_type=1, n_mels=12, n_fft=64, hop_length=16, samples_per_token=32,
               resnet_blocks=0, vocoder_upsample_rates=(4, 2, 2), vocoder_num_kernels=2)


@pytest.fixture(scope="module", autouse=True)
def logical_ranks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(LOGICAL_ENV, "8")
        mp.setenv("MIOTTS_PLATFORM", "cpu")
        yield


def _ranks(n):
    return logical_devices("cpu")[:n]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """The JAX test's codecs (the port's writers write the same bytes)."""
    d = tmp_path_factory.mktemp("tsp")
    out = {"plain": d / "codec.gguf", "ups": d / "codec_ups.gguf", "mel": d / "mel.gguf"}
    write_synthetic_miocodec_gguf(str(out["plain"]), tiny_codec_config(), seed=0)
    write_synthetic_miocodec_gguf(str(out["ups"]), tiny_codec_config(
        wave_upsampler_factors=(2, 2), wave_upsampler_kernel_sizes=(4, 4)), seed=0)
    write_synthetic_mel_vocoder_gguf(str(out["mel"]), tiny_codec_config(**MEL_CFG), seed=0)
    return {k: str(v) for k, v in out.items()}


_CACHE: dict = {}


def _pipe(kind, paths, path, sp=None):
    """One pipeline per (package, codec, sp), built once: a JAX pipeline
    keeps its compiled decodes."""
    key = (kind, path, sp)
    if key not in _CACHE:
        if kind == "jax":
            _CACHE[key] = JaxPipeline(paths[path], sp_devices=jax.devices()[:sp])
        else:
            _CACHE[key] = MioTTSPipeline(paths[path], CPU,
                                         sp_devices=None if sp is None else _ranks(sp))
    return _CACHE[key]


def _codes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 128, size=n).astype(np.int32)


def _emb(seed=0):
    return (np.random.default_rng(seed + 100).standard_normal(16) * 0.1).astype(np.float32)


def _three_way(paths, path, sp, codes, emb, **kw):
    """The port's sp decode against its mesh-less decode and JAX's sp decode."""
    got = _pipe("torch", paths, path, sp).synthesize(codes, emb, **kw)
    plain = _pipe("torch", paths, path).synthesize(codes, emb, **kw)
    ref = _pipe("jax", paths, path, sp).synthesize(codes, emb, **kw)
    for what, other in (("mesh-less", plain), ("JAX sp", ref)):
        assert len(got.audio) == len(other.audio), what
        assert got.n_frames == other.n_frames and got.n_total == other.n_total, what
        np.testing.assert_allclose(got.audio, other.audio, atol=ATOL, rtol=0, err_msg=what)
    return got


def test_sp_mesh_shape():
    mesh = make_sp_mesh(_ranks(8), sp=4)
    assert isinstance(mesh, SpMesh)
    assert mesh.shape == {"sp": 4} == dict(jax.sharding.Mesh(
        np.asarray(jax.devices()[:4]), ("sp",)).shape)
    assert mesh.axis_names == ("sp",)
    assert mesh.devices.dtype == object and all(isinstance(d, Device) for d in mesh.devices)
    assert [d.id for d in mesh.devices] == [0, 1, 2, 3] and mesh.one_device


def test_sp_mesh_oversized_raises():
    with pytest.raises(ValueError, match="sp=9 > 8 devices"):
        make_sp_mesh(_ranks(8), sp=9)


def test_sp_weights_single_upload_replicated(paths, monkeypatch):
    """One tree for every rank, uploaded once for their one physical device,
    each leaf (packed route forced) bit-equal to the per-leaf upload and to
    JAX's replicated leaf."""
    monkeypatch.setenv("MIOTTS_DEVICE_DEQUANT", "1")
    pipe = MioTTSPipeline(paths["plain"], CPU, sp_devices=_ranks(4))
    assert len(pipe.sp_weights) == 4 and pipe.weights is pipe.sp_weights[0]
    assert all(t is pipe.sp_weights[0] for t in pipe.sp_weights)
    jpipe = _pipe("jax", paths, "plain", 8)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        elif tree is not None:
            yield prefix, tree
    per_leaf = dict(leaves(tree_to_device(_host_tree(paths["plain"]), CPU)))
    jax_leaves = dict(leaves(jpipe.weights))
    got = dict(leaves(pipe.weights))
    assert got.keys() == per_leaf.keys()
    assert len(got.keys() & jax_leaves.keys()) == len(got) - 1  # all but the port's Hann window
    for name, t in got.items():
        assert t.device == CPU and torch.equal(t, per_leaf[name]), name
        if name in jax_leaves:
            j = jax_leaves[name]
            assert len(j.sharding.device_set) == 8 and j.sharding.is_fully_replicated
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def _host_tree(path):
    """The codec's host tree as ``load_miocodec`` builds it, before upload."""
    captured = {}

    def keep(tree, device, sharding=None):
        captured["tree"] = tree
        return tree
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(miocodec, "device_put_packed", keep)
        miocodec.load_miocodec(path, CPU)
    return captured["tree"]


@pytest.mark.parametrize("sp", [2, 8])
def test_sp_decode_matches_single_device(paths, sp):
    _three_way(paths, "plain", sp, _codes(300), _emb())


def test_sp_decode_matches_with_wave_upsampler(paths):
    _three_way(paths, "ups", 8, _codes(137, seed=1), _emb(seed=1))


def test_sp_ragged_lengths_match(paths):
    """Lengths that split unevenly: the masked tail crosses a shard edge."""
    for n in (33, 61, 100):
        _three_way(paths, "plain", 8, _codes(n, seed=n), _emb(seed=n))


def test_sp_window_fetch_matches(paths):
    got = _three_way(paths, "plain", 8, _codes(80, seed=7), _emb(seed=7), window=(256, 512),
                     peak_normalize=False)
    assert got.window_start == 256 and len(got.audio) == 512


def test_sp_cli_flag(paths, tmp_path, monkeypatch):
    """--sequence-parallel 8 through the port's CLI: its WAV within 2 int16
    steps of the mesh-less CLI's and of the JAX CLI's --sequence-parallel 8."""
    codes_txt = tmp_path / "codes.txt"
    codes_txt.write_text("\n".join(str(c) for c in _codes(50, seed=3)))
    emb_path = tmp_path / "ref.emb.gguf"
    save_embedding_gguf(str(emb_path), _emb(seed=3))
    base = ["-mv", paths["plain"], "--tts-mio-codes-in", str(codes_txt),
            "--tts-mio-embedding-in", str(emb_path)]
    outs = {}
    sp8 = ["--sequence-parallel", "8"]
    for name, extra, main in (("one", [], cli.main), ("sp8", sp8, cli.main),
                              ("jax", sp8, jax_cli_main)):
        outs[name] = tmp_path / f"{name}.wav"
        assert main(base + ["-o", str(outs[name])] + extra) == 0
    audio = {k: load_audio(str(v)) for k, v in outs.items()}
    for other in ("one", "jax"):
        assert audio["sp8"][1] == audio[other][1]
        assert audio["sp8"][0].shape == audio[other][0].shape
        assert np.max(np.abs(audio["sp8"][0] - audio[other][0])) <= 2.0 / 32767.0


def test_sp_mel_mode(paths):
    """Mel mode: the vocoder's stages on each rank's halo-extended rows."""
    _three_way(paths, "mel", 2, _codes(96, seed=5), _emb(seed=5))
    # a length whose end falls inside a halo, and 3 ranks
    plain = _pipe("torch", paths, "mel").synthesize(_codes(61, seed=6), _emb(seed=6))
    got = _pipe("torch", paths, "mel", 3).synthesize(_codes(61, seed=6), _emb(seed=6))
    np.testing.assert_allclose(got.audio, plain.audio, atol=ATOL, rtol=0)


def test_sp_calls_the_kernel_wrappers_on_every_rank(paths, monkeypatch):
    """The sp decode calls K1's wrapper (``ops/attention.banded_attention``)
    and the vocoder's K4/K5/K6 wrappers as often on every rank as the
    mesh-less decode calls them (the fused K6 route forced at these small
    shapes by a threshold of 1 row); on the card those wrappers reach the
    kernels."""
    calls: dict = {}

    def counting(name, fn):
        def wrapper(*a, **k):
            rank = getattr(graphs._tls, "rank", None)
            calls[(name, rank)] = calls.get((name, rank), 0) + 1
            return fn(*a, **k)
        return wrapper
    monkeypatch.setattr(miocodec, "banded_attention",
                        counting("k1", miocodec.banded_attention))
    for name, mod, fn in (("k4", vocoder.k4, "conv1d_same"), ("k5", vocoder.k5, "activation1d"),
                          ("k6", vocoder.k6, "resblock_layer")):
        monkeypatch.setattr(mod, fn, counting(name, getattr(mod, fn)))
    monkeypatch.setattr(vocoder, "_FUSE_MIN_ROWS", 1)
    codes, emb = _codes(96, seed=5), _emb(seed=5)
    for sp in (None, 4):
        pipe = MioTTSPipeline(paths["mel"], CPU, sp_devices=None if sp is None else _ranks(sp))
        pipe.synthesize(codes, emb)
    mesh_less = {name: n for (name, rank), n in calls.items() if rank is None}
    assert set(mesh_less) == {"k1", "k4", "k5", "k6"} and mesh_less["k1"] == 4
    for r in range(4):
        assert {name: n for (name, rank), n in calls.items() if rank == r} == mesh_less, r


# -- the sharded ops against their mesh-less ops -------------------------------------------

SPS = [2, 3, 8]


def _mesh(sp):
    return make_sp_mesh(_ranks(sp))


def _lens(mesh, values):
    return seq.replicate(torch.tensor(values, dtype=torch.int32), mesh)


@pytest.mark.parametrize("sp", SPS)
def test_split_join_fetch_halo(sp):
    x = torch.randn(2, 37, 3, generator=torch.Generator().manual_seed(sp))
    s = seq.split(x, _mesh(sp))
    assert s.ranges == seq.split_rows(37, sp) and torch.equal(seq.join(s), x)
    h = seq.halo(s, 4, 9)
    pad = torch.cat([torch.zeros(2, 4, 3), x, torch.zeros(2, 9, 3)], dim=1)
    for (a, b), p in zip(s.ranges, h.parts):
        assert torch.equal(p, pad[:, a:b + 13])
    t = seq.halo(s, 4, 9, edge="trim")
    for (a, b), p, st in zip(s.ranges, t.parts, t.starts):
        assert st == max(0, a - 4) and torch.equal(p, x[:, st:min(37, b + 9)])


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("k,dil", [(3, 1), (7, 3)])
def test_halo_conv(sp, k, dil):
    g = torch.Generator().manual_seed(k + sp)
    x = torch.randn(2, 41, 6, generator=g)
    w, b = torch.randn(5, 6, k, generator=g), torch.randn(5, generator=g)
    lens = [41, 30]
    reach = dil * (k // 2)

    def conv(x, lengths):
        return mask_time(conv1d_zeropad(mask_time(x, lengths), w, b, dil, reach), lengths)
    ref = conv(x, torch.tensor(lens))
    mesh = _mesh(sp)
    ll = _lens(mesh, lens)
    got = seq.on_halo(seq.split(x, mesh), reach, reach, lambda r, p, start: conv(
        p, seq.local_lengths(ll[r], start, p.shape[1])), edge="zeros")
    torch.testing.assert_close(seq.join(got), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("k,stride,crop", [(4, 2, 0), (7, 3, 2), (4, 2, 1)])
def test_conv_transpose_resplit(sp, k, stride, crop):
    g = torch.Generator().manual_seed(sp * k)
    x = torch.randn(2, 19, 4, generator=g)
    w, b = torch.randn(4, 3, k, generator=g), torch.randn(3, generator=g)
    ref = conv_transpose1d(x, w, b, stride=stride)
    ref = ref[:, crop:ref.shape[1] - crop]
    got = seq.conv_transpose(seq.split(x, _mesh(sp)),
                             lambda r, p: conv_transpose1d(p, w, b, stride=stride), k, stride, crop)
    assert got.ranges == seq.split_rows(ref.shape[1], sp)
    torch.testing.assert_close(seq.join(got), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("override", [None, (23, 16)])
def test_gather_rows_resize(sp, override):
    g = torch.Generator().manual_seed(sp)
    x = torch.randn(2, 29, 5, generator=g)
    src, dst = [29, 17], [40, 22]
    ref = linear_interpolate(x, torch.tensor(src), torch.tensor(dst), 43, scale_override=override)
    mesh = _mesh(sp)
    got = seq.interpolate(seq.split(x, mesh), _lens(mesh, src), _lens(mesh, dst), 43, override)
    torch.testing.assert_close(seq.join(got), ref, atol=0, rtol=0)


@pytest.mark.parametrize("sp", SPS)
def test_two_pass_group_norm(sp):
    x = torch.randn(2, 37, 8, generator=torch.Generator().manual_seed(sp)) * 3 + 1
    lens = [37, 11]
    ref = masked_group_norm(x, torch.tensor(lens), 4, eps=1e-6)
    mesh = _mesh(sp)
    got = seq.join(seq.group_norm(seq.split(x, mesh), _lens(mesh, lens), 4, 1e-6))
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("n_fft,hop", [(64, 16), (30, 12)])
def test_overlap_add_seam(sp, n_fft, hop):
    g = torch.Generator().manual_seed(sp + n_fft)
    L = 21
    spec = torch.randn(2, L, n_fft + 2, generator=g) * 0.5
    lens = [L, 13]
    tables = tuple(torch.from_numpy(t) for t in dft_tables(n_fft))
    ref = spec_to_audio(spec, torch.tensor(lens), n_fft, hop, tables)
    mesh = _mesh(sp)
    got = seq.overlap_add(seq.split(spec, mesh), _lens(mesh, lens), n_fft, hop, [tables] * sp)
    assert got.ranges == seq.split_rows(ref.shape[1], sp)
    torch.testing.assert_close(seq.join(got), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sp", SPS)
def test_sp_max_peak(sp):
    a = torch.randn(3, 50, generator=torch.Generator().manual_seed(sp)) * 0.3
    a[0, 41] = 2.5   # a clipped example, its peak on one rank only
    a[1, 3] = float("inf")  # a non-finite sample does not set the peak
    a[1, 7] = -1.4
    mesh = _mesh(sp)
    got = seq.join(seq.peak_normalize(seq.split(a, mesh)))
    finite = torch.where(torch.isfinite(a), a, torch.zeros(()))
    peak = finite.abs().amax(dim=1)
    gain = torch.where(peak > 0.98, 0.95 / torch.clamp(peak, min=1e-9), torch.ones(()))
    torch.testing.assert_close(got, a * gain[:, None], atol=0, rtol=0)
    parts = [torch.tensor([float(r), -r]) for r in range(sp)]
    assert all(torch.equal(m, torch.tensor([sp - 1.0, 0.0])) for m in seq.sp_max(parts, mesh))
    assert all(torch.equal(m, torch.tensor([sum(range(sp)) * 1.0, -sum(range(sp)) * 1.0]))
               for m in seq.sp_sum(parts, mesh))


def test_ranks_without_rows():
    """An axis shorter than the mesh: the last ranks hold no rows and run
    nothing, and the ops still equal their mesh-less forms."""
    mesh = _mesh(8)
    x = torch.randn(1, 10, 4, generator=torch.Generator().manual_seed(1))
    s = seq.split(x, mesh)
    assert [b - a for a, b in s.ranges] == [2, 2, 2, 2, 2, 0, 0, 0]
    w = torch.randn(4, 4, 4, generator=torch.Generator().manual_seed(2))
    ref = conv_transpose1d(x, w, None, stride=2)
    got = seq.conv_transpose(s, lambda r, p: conv_transpose1d(p, w, None, stride=2), 4, 2)
    torch.testing.assert_close(seq.join(got), ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(
        seq.join(seq.on_halo(s, 1, 1, lambda r, p, start: conv1d_same(p, w[:, :, :3]))),
        conv1d_same(x, w[:, :, :3]), atol=1e-6, rtol=0)
