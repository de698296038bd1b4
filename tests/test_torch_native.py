"""The port's native host runtime (miotts_tpu_torch/runtime/native.py and
its C++, runtime/native/miotts_runtime.cpp) and its callers against the JAX
package's library (miotts_tpu.runtime.native) and numpy.

Both packages build the same C++ (the port's copy leaves out only the mp3
decoder), so every entry point is held bit-equal to JAX's: the whole-tensor
GGUF dequant for each type it takes, at one and several threads; the
``dequantize`` dispatch (native from 2^16 elements on, numpy below it and
for F32) in value and dtype, and its numpy route under MIOTTS_NO_NATIVE;
the WAV encoder, with values past +-1 and exact half-steps of 1/32767 (so
``lrintf`` is seen to round half to even, as ``np.rint`` does); the FLAC
decoder over tests/flac_encoder.py's subframe kinds, channel modes, wasted
bits, partition orders, escaped partitions and short last frames, and over
streams whose STREAMINFO gives no sample count (the grow-and-retry loop);
``load_audio`` on a FLAC, answered by the library; the linear resampler
(bit-equal to JAX's native, within 1e-6 of numpy's ``resample_linear``);
the mp3 decoder (ABI 6) against the port's numpy ``decode_mp3`` and JAX's
native and numpy decoders over MPEG-1/2/2.5, mono, stereo, joint stereo,
CRC frames, LAME's Info frame, Xing and VBRI frames and the committed
fixtures (tests/torch_assets), over mutated streams (numpy's answer or
None, never a write past the buffer), its routing in ``load_audio``
(MIOTTS_NATIVE_MP3) and its generated tables (mp3_tables.h, equal to
JAX's). Skipped only where no C++ compiler can build the library."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from flac_encoder import encode_flac  # noqa: E402
from mp3_oracles import have_oracles, lame_encode  # noqa: E402
from torch_lame import lame_stream  # noqa: E402

from miotts_tpu.gguf import quants as jax_quants  # noqa: E402
from miotts_tpu.runtime import audio_io as jax_audio  # noqa: E402
from miotts_tpu.runtime import mp3 as jax_mp3  # noqa: E402
from miotts_tpu.runtime import native as jax_native  # noqa: E402
from miotts_tpu_torch.gguf import quants  # noqa: E402
from miotts_tpu_torch.gguf.quants import GGMLType  # noqa: E402
from miotts_tpu_torch.runtime import audio_io, build_native, flac, mp3, native  # noqa: E402

pytestmark = pytest.mark.skipif(build_native.compiler() is None,
                                reason="no C++ compiler (g++ or clang++) to build the native library")

ASSETS = Path(__file__).parent / "torch_assets"  # scripts/gen_torch_mp3_fixtures.py
needs_oracles = pytest.mark.skipif(not have_oracles(), reason="lame/mpg123 not in image")

# (GGML type, elements a block, bytes a block, byte offsets of f16 scales)
TYPES = {
    "F32": (0, 1, 4, ()),
    "F16": (1, 1, 2, ()),
    "Q4_0": (2, 32, 18, (0,)),
    "Q8_0": (8, 32, 34, (0,)),
    "Q6_K": (14, 256, 210, (208,)),
    "BF16": (30, 1, 2, ()),
}


def _finite_f16(rng, n: int) -> np.ndarray:
    """``n`` f16 bit patterns, subnormals, zeros of both signs and
    infinities among them, no NaN (numpy's f16 view and the C conversion
    then agree as values)."""
    bits = rng.randint(0, 1 << 16, n).astype(np.uint16)
    nan = ((bits & 0x7C00) == 0x7C00) & ((bits & 0x03FF) != 0)
    bits[nan] &= 0xFC00  # an infinity of the same sign
    return bits


def _raw(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """Random GGUF bytes of ``n`` elements of ``kind``: payload bytes drawn
    whole, every f16 scale (and every F16 element) finite, F32 and BF16
    finite too."""
    ggml, block, nbytes, scales = TYPES[kind]
    rng = np.random.RandomState(seed)
    if kind == "F32":
        return (rng.randn(n) * 3).astype(np.float32).view(np.uint8)
    if kind == "F16":
        return _finite_f16(rng, n).view(np.uint8)
    if kind == "BF16":
        x = (rng.randn(n) * 10.0 ** rng.randint(-30, 30, n)).astype(np.float32)
        return (x.view(np.uint32) >> 16).astype(np.uint16).view(np.uint8)
    blocks = rng.randint(0, 256, (n // block, nbytes)).astype(np.uint8)
    for off in scales:
        blocks[:, off:off + 2] = _finite_f16(rng, n // block).view(np.uint8).reshape(-1, 2)
    return blocks.reshape(-1)


def _bits(x: np.ndarray) -> np.ndarray:
    """f32 bit patterns of ``x``'s values (an f16 view widened exactly)."""
    return np.asarray(x).astype(np.float32).view(np.uint32)


def _forget_libraries(monkeypatch) -> None:
    """MIOTTS_NO_NATIVE with both packages' libraries forgotten, as
    tests/test_native.py resets JAX's; each is put back after the test."""
    monkeypatch.setenv("MIOTTS_NO_NATIVE", "1")
    for name, value in (("_lib", None), ("_tried", False), ("_reason", "")):
        monkeypatch.setattr(native, name, value)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)
    assert not native.available() and "MIOTTS_NO_NATIVE" in native.unavailable_reason()


@pytest.fixture
def no_native(monkeypatch):
    _forget_libraries(monkeypatch)


def test_library_abi_and_entry_points():
    """ABI 6, JAX's library version, the port's own file beside JAX's, the
    mp3 entry points bound."""
    lib = native._load()
    assert native.available() and lib is not None and native.unavailable_reason() == ""
    assert lib.mio_runtime_abi_version() == native.ABI == 6
    assert lib.mio_runtime_abi_version() == jax_native._load().mio_runtime_abi_version()
    assert lib._name != jax_native._load()._name
    assert native.NATIVE_DEQUANT_TYPES == jax_native.NATIVE_DEQUANT_TYPES
    assert lib.mio_mp3_probe.argtypes and lib.mio_mp3_decode.argtypes
    assert Path(lib._name).name.startswith("libmiotts_runtime_")


@pytest.mark.parametrize("threads", [1, 3, 0])
@pytest.mark.parametrize("blocks", [7, 1500])
@pytest.mark.parametrize("kind", sorted(TYPES))
def test_dequantize_native_matches_jax(kind, blocks, threads):
    """Bit-equal to JAX's library at one, three and the default threads,
    below the 1 024 blocks where the C splits the work and above them."""
    ggml, block, _, _ = TYPES[kind]
    n = blocks * block
    raw = _raw(kind, n, seed=blocks)
    c0 = native.calls["mio_dequant"]
    got = native.dequantize_native(raw, ggml, n, n_threads=threads)
    want = jax_native.dequantize_native(raw, ggml, n, n_threads=threads)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert native.calls["mio_dequant"] == c0 + 1


@pytest.mark.parametrize("size", ["under", "2^17"])
@pytest.mark.parametrize("kind", sorted(TYPES))
def test_dequantize_dispatch_matches_jax(kind, size):
    """``dequantize`` at a whole number of blocks just under 2^16 elements
    (numpy) and at 2^17 (native, but for F32): JAX's value and dtype, and
    the library answered exactly where JAX's dispatch asks it to."""
    ggml, block, _, _ = TYPES[kind]
    n = ((1 << 16) // block - 1) * block if size == "under" else 1 << 17
    raw = _raw(kind, n, seed=n % 97)
    c0 = native.calls["mio_dequant"]
    got = quants.dequantize(raw, ggml, n)
    want = jax_quants.dequantize(raw, ggml, n)
    assert got.dtype == want.dtype and got.shape == want.shape == (n,)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    native_route = size == "2^17" and kind != "F32"
    assert native.calls["mio_dequant"] == c0 + native_route
    if native_route:
        assert got.dtype == np.float32
    elif kind == "F16":
        assert got.dtype == np.float16


@pytest.mark.parametrize("kind", sorted(TYPES))
def test_dequantize_no_native_same_values(kind, monkeypatch):
    """Under MIOTTS_NO_NATIVE the 2^17-element tensor takes numpy in both
    packages and keeps the native route's values (F16 as its f16 view)."""
    ggml = TYPES[kind][0]
    n = 1 << 17
    raw = _raw(kind, n, seed=5)
    routed = quants.dequantize(raw, ggml, n)
    _forget_libraries(monkeypatch)
    c0 = native.calls["mio_dequant"]
    got = quants.dequantize(raw, ggml, n)
    assert native.calls["mio_dequant"] == c0
    want = jax_quants.dequantize(raw, ggml, n)
    assert got.dtype == want.dtype == (np.float16 if kind == "F16" else np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(routed))


def test_dequantize_native_refuses_other_types():
    """A type the C does not take (Q4_K) is None, and ``dequantize`` gives
    numpy's values, as JAX's does."""
    n = 1 << 17
    raw = np.random.RandomState(2).randint(0, 256, n // 256 * 144).astype(np.uint8)
    scales = (np.random.RandomState(3).rand(2 * n // 256) * 0.1).astype(np.float16)
    raw.reshape(-1, 144)[:, :4] = scales.view(np.uint8).reshape(-1, 4)
    assert native.dequantize_native(raw, GGMLType.Q4_K, n) is None
    np.testing.assert_array_equal(_bits(quants.dequantize(raw, GGMLType.Q4_K, n)),
                                  _bits(jax_quants.dequantize(raw, GGMLType.Q4_K, n)))


def _half_steps(rng, count: int) -> np.ndarray:
    """f32 values whose product with 32767 (in f32) is exactly k + 1/2."""
    k = rng.randint(-32767, 32767, 8 * count)
    x = ((k + 0.5) / 32767.0).astype(np.float32)
    exact = (x * np.float32(32767.0)).astype(np.float64) == k + 0.5
    x = x[exact][:count]
    assert x.size == count
    return x


@pytest.mark.parametrize("case", ["noise", "past_one", "half_steps", "float64", "empty"])
def test_encode_wav16_matches_jax(case):
    """``encode_wav16`` and ``save_wav16`` bytes equal JAX's and the numpy
    route's; half-steps round to even as ``np.rint`` does."""
    rng = np.random.RandomState(7)
    audio = {
        "noise": lambda: (rng.randn(4001) * 0.5).astype(np.float32),
        "past_one": lambda: np.concatenate([np.float32([1.0, -1.0, 1.5, -7.0, 1e30, -1e30,
                                                        np.inf, -np.inf, 0.99999]),
                                            (rng.randn(100) * 3).astype(np.float32)]),
        "half_steps": lambda: _half_steps(rng, 512),
        "float64": lambda: rng.randn(999) * 0.7,
        "empty": lambda: np.zeros(0, np.float32),
    }[case]()
    c0 = native.calls["mio_encode_wav16"]
    got = audio_io.encode_wav16(audio, 44100)
    assert native.calls["mio_encode_wav16"] == c0 + 1
    assert got == jax_audio.encode_wav16(audio, 44100)
    pcm = np.rint(np.clip(audio.astype(np.float32), -1, 1) * np.float32(32767)).astype("<i2")
    assert got == audio_io.wav16_header(pcm.size, 44100) + pcm.tobytes()
    assert got[44:] == audio_io.encode_pcm16(audio)
    if case == "half_steps":
        frac = np.abs(audio * np.float32(32767)) % 1
        assert np.all(frac == 0.5) and np.all(pcm % 2 == 0)


def test_encode_wav16_no_native_and_int16(tmp_path, monkeypatch):
    """Numpy writes the library's bytes; int16 passes through untouched."""
    rng = np.random.RandomState(8)
    audio = np.concatenate([(rng.randn(1000) * 0.8).astype(np.float32), _half_steps(rng, 64)])
    routed = audio_io.encode_wav16(audio, 24000)
    _forget_libraries(monkeypatch)
    c0 = native.calls["mio_encode_wav16"]
    got = audio_io.encode_wav16(audio, 24000)
    assert native.calls["mio_encode_wav16"] == c0
    assert got == routed == jax_audio.encode_wav16(audio, 24000)
    pcm = rng.randint(-32768, 32767, 77).astype(np.int16)
    assert audio_io.encode_wav16(pcm, 24000) == jax_audio.encode_wav16(pcm, 24000)
    audio_io.save_wav16(tmp_path / "a.wav", audio, 24000)
    assert (tmp_path / "a.wav").read_bytes() == got


def test_save_wav16_goes_native(tmp_path):
    audio = (np.random.RandomState(9).randn(3000) * 0.4).astype(np.float32)
    c0 = native.calls["mio_encode_wav16"]
    audio_io.save_wav16(tmp_path / "a.wav", audio, 24000)
    jax_audio.save_wav16(tmp_path / "b.wav", audio, 24000)
    assert native.calls["mio_encode_wav16"] == c0 + 1
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


def _mono16(n, seed, sr=16000):
    rng = np.random.RandomState(seed)
    x = 8000 * np.sin(2 * np.pi * 440 * np.arange(n) / sr) + rng.randn(n) * 300
    return np.clip(x, -32768, 32767).astype(np.int64)


def _stereo16(n, seed, sr=44100):
    left = _mono16(n, seed, sr)
    return np.stack([left, np.roll(left, 7) // 2 + _mono16(n, seed + 1, sr) // 3], 1)


def _unknown_length(data: bytes) -> bytes:
    """The stream with STREAMINFO's 36-bit total-samples field zeroed (the
    field's low 36 bits of the 8 bytes after the frame sizes)."""
    out = bytearray(data)
    v = int.from_bytes(out[18:26], "big") & ~((1 << 36) - 1)
    out[18:26] = v.to_bytes(8, "big")
    return bytes(out)


FLAC_CASES = {
    "constant": lambda: encode_flac(np.full(9000, -1234, np.int64), 16000,
                                    subframe_kind="constant"),
    "verbatim": lambda: encode_flac(_mono16(9000, 1), 16000, subframe_kind="verbatim"),
    "fixed0": lambda: encode_flac(_mono16(5000, 2), 16000, subframe_kind="fixed0"),
    "fixed1": lambda: encode_flac(_mono16(5000, 2), 16000, subframe_kind="fixed1"),
    "fixed2_po2": lambda: encode_flac(_mono16(9000, 1), 16000, subframe_kind="fixed2",
                                      partition_order=2),
    "lpc2": lambda: encode_flac(_mono16(9000, 1), 24000, subframe_kind="lpc2"),
    "lpc2_short_blocks": lambda: encode_flac(_mono16(5000, 4), 24000, block_size=1152,
                                             subframe_kind="lpc2", partition_order=3),
    "independent": lambda: encode_flac(_stereo16(10000, 5, 22050), 22050,
                                       subframe_kind="fixed2", channel_mode="independent"),
    "left_side_escape": lambda: encode_flac(np.stack([_mono16(5000, 3), _mono16(5000, 4)], 1),
                                            16000, subframe_kind="fixed2",
                                            channel_mode="left_side", partition_order=2,
                                            escape_parts={1, 3}),
    "mid_side_lpc": lambda: encode_flac(_stereo16(20000, 6), 44100, subframe_kind="lpc2",
                                        channel_mode="mid_side", partition_order=2),
    "wasted": lambda: encode_flac((_mono16(5000, 3) >> 2) << 2, 16000, subframe_kind="fixed1",
                                  wasted=2),
    "wasted_escape": lambda: encode_flac((_mono16(6000, 8) >> 3) << 3, 16000,
                                         subframe_kind="fixed2", partition_order=2,
                                         escape_parts={0, 2}, wasted=3),
    "unknown_length_constant": lambda: _unknown_length(encode_flac(
        np.full(40000, 321, np.int64), 16000, subframe_kind="constant")),
    "unknown_length_stereo": lambda: _unknown_length(encode_flac(
        np.stack([np.full(9000, -5, np.int64), np.full(9000, 77, np.int64)], 1), 22050,
        subframe_kind="constant", channel_mode="mid_side")),
    "unknown_length_lpc": lambda: _unknown_length(encode_flac(
        _mono16(7000, 9), 16000, subframe_kind="lpc2")),
}


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_flac_decode_native_matches_jax_and_numpy(case):
    """Bit-equal samples and the same rate from the port's library, JAX's
    and the port's numpy ``decode_flac``."""
    data = FLAC_CASES[case]()
    c0 = native.calls["mio_flac_decode"]
    got, rate = native.flac_decode_native(data)
    assert native.calls["mio_flac_decode"] == c0 + 1
    want, want_rate = jax_native.flac_decode_native(data)
    ref, ref_rate = flac.decode_flac(data)
    assert rate == want_rate == ref_rate
    assert got.dtype == want.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    if case.startswith("unknown_length"):
        channels = 2 if "stereo" in case else 1
        # the first buffer is too small: the decode grew it and retried
        if "lpc" not in case:
            assert max(4096, len(data) * 4 // channels) < got.size


@pytest.mark.parametrize("data", [b"", b"fLaC", b"RIFF0000WAVE", b"fLaC" + bytes(60),
                                  FLAC_CASES["lpc2"]()[:300]])
def test_flac_decode_native_garbage_as_jax(data):
    """Streams that are no FLAC, a zeroed STREAMINFO (no frames: an empty
    decode at rate 0) and a cut stream answer as JAX's library does."""
    got, want = native.flac_decode_native(data), jax_native.flac_decode_native(data)
    assert (got is None) == (want is None)
    if got is not None:
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
    if data[:4] != b"fLaC" or len(data) < 42:
        assert got is None


def _short_frame_stream(ftype: int, order: int) -> bytes:
    """A mono 16-bit stream whose one frame holds a single sample (block
    size code 6, 8-bit size 0) but a predictor of ``order`` warm-up samples:
    FIXED order 4 (ftype 12) or LPC order 32 (ftype 63)."""
    rate, bps, total = 16000, 16, 1
    fields = [(16, 16), (16, 16), (24, 0), (24, 0), (20, rate), (3, 0), (5, bps - 1),
              (36, total)]
    v = 0
    for width, value in fields:
        v = (v << width) | value
    info = v.to_bytes(18, "big") + bytes(16)
    bits = [(14, 0x3FFE), (1, 0), (1, 0), (4, 6), (4, 0), (4, 0), (3, 0), (1, 0),
            (8, 0), (8, 0), (8, 0),                   # utf8 frame 0, size - 1, CRC-8
            (1, 0), (6, ftype), (1, 0)]               # subframe header, no wasted bits
    bits += [(bps, 0x1234)] * order                   # warm-up
    if ftype >= 32:
        bits += [(4, 14), (5, 3)] + [(15, 0x0101)] * order  # precision, shift, coefs
    bits += [(2, 0), (4, 0)]                          # residual: rice, partition order 0
    v = n = 0
    for width, value in bits:
        v, n = (v << width) | value, n + width
    v <<= -n % 8
    frame = v.to_bytes((n + 7) // 8, "big")
    return b"fLaC" + bytes([0x80, 0, 0, 34]) + info + frame + bytes(range(256)) * 4


@pytest.mark.parametrize("ftype,order", [(12, 4), (63, 32)])
def test_flac_frame_shorter_than_its_warm_up(tmp_path, ftype, order):
    """A frame of one sample under an order-4 FIXED or order-32 LPC
    predictor is refused before its warm-up is written past the frame's
    samples: the library answers None, and ``load_audio`` falls back to
    numpy, which refuses the stream too."""
    data = _short_frame_stream(ftype, order)
    assert native.flac_decode_native(data) is None
    with pytest.raises(ValueError, match="flac"):
        flac.decode_flac(data)
    p = tmp_path / "short.flac"
    p.write_bytes(data)
    with pytest.raises(ValueError, match="flac"):
        audio_io.load_audio(p)


@pytest.mark.parametrize("route", ["native", "no_native"])
def test_load_audio_flac(tmp_path, route, request):
    """``load_audio`` on a FLAC: the library answers (or numpy does under
    MIOTTS_NO_NATIVE), with JAX's samples, resampled and cut alike."""
    if route == "no_native":
        request.getfixturevalue("no_native")
    p = tmp_path / "ref.flac"
    p.write_bytes(FLAC_CASES["mid_side_lpc"]())
    c0 = native.calls["mio_flac_decode"]
    for kw in ({}, {"target_rate": 16000, "max_seconds": 0.25}):
        x, rate = audio_io.load_audio(p, **kw)
        y, want_rate = jax_audio.load_audio(p, **kw)
        assert rate == want_rate and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert native.calls["mio_flac_decode"] == c0 + (2 if route == "native" else 0)


@pytest.mark.parametrize("src,dst", [(24000, 16000), (44100, 16000), (16000, 24000),
                                     (22050, 16000), (8000, 44100), (16000, 16000)])
def test_resample_linear_native(src, dst):
    """Bit-equal to JAX's native resampler, within 1e-6 of numpy's."""
    x = np.random.RandomState(src + dst).randn(src // 3).astype(np.float32)
    got = native.resample_linear_native(x, src, dst)
    want = jax_native.resample_linear_native(x, src, dst)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    ref = audio_io.resample_linear(x, src, dst)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_calls_count_only_library_answers(no_native):
    """Every public entry point is None without the library, and counts
    nothing."""
    before = dict(native.calls)
    x = np.ones(64, np.float32)
    assert native.dequantize_native(_raw("F16", 64), 1, 64) is None
    assert native.encode_wav16_native(x, 24000) is None
    assert native.resample_linear_native(x, 24000, 16000) is None
    assert native.flac_decode_native(FLAC_CASES["constant"]()) is None
    assert native.mp3_decode_native((ASSETS / "ref3.mp3").read_bytes()) is None
    assert dict(native.calls) == before


def test_native_routes_import_no_jax(tmp_path):
    """In a fresh interpreter the library loads, and a FLAC decode, an mp3
    decode, a large dequant and a WAV encode go native, with no ``jax`` or
    ``miotts_tpu`` module imported."""
    import subprocess

    p = tmp_path / "a.flac"
    p.write_bytes(FLAC_CASES["lpc2"]())
    probe = f"""
import sys
import numpy as np
from miotts_tpu_torch.gguf.quants import dequantize
from miotts_tpu_torch.runtime import audio_io, native
x, rate = audio_io.load_audio({str(p)!r})
y, _ = audio_io.load_audio({str(ASSETS / "ref3.mp3")!r}, 16000)
w = dequantize(np.zeros(1 << 17, np.uint16).view(np.uint8), 1, 1 << 17)
wav = audio_io.encode_wav16(x, rate)
assert native.available() and w.dtype == np.float32, native.unavailable_reason()
entries = ("mio_flac_decode", "mio_mp3_decode", "mio_dequant", "mio_encode_wav16")
assert {{k: native.calls[k] for k in entries}} == dict.fromkeys(entries, 1), native.calls
bad = sorted(m for m in sys.modules if m in ("jax", "miotts_tpu")
             or m.startswith(("jax.", "jaxlib", "miotts_tpu.")))
assert not bad, bad
"""
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", probe], cwd=repo, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.parametrize("kind", sorted(TYPES))
def test_dequantize_numpy_is_the_numpy_route(kind, monkeypatch):
    """``dequantize_numpy`` at 2^17 elements is what ``dequantize`` gives
    without the library, bit for bit and in dtype."""
    ggml = TYPES[kind][0]
    raw = _raw(kind, 1 << 17, seed=6)
    got = quants.dequantize_numpy(raw, ggml, 1 << 17)
    _forget_libraries(monkeypatch)
    want = quants.dequantize(raw, ggml, 1 << 17)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kind", ["F16", "Q8_0", "Q6_K"])
def test_dequantize_native_refuses_short_buffers(kind):
    """Fewer bytes than the elements need: None, never a read past the
    buffer (numpy then answers as it would)."""
    ggml, block, nbytes, _ = TYPES[kind]
    n = 4096 * block
    raw = _raw(kind, n)
    assert native.dequantize_native(raw[:-1], ggml, n) is None
    assert native.dequantize_native(raw, ggml, n) is not None


def test_calls_count_every_thread():
    """The counts lose no call when many threads answer at once."""
    import threading

    audio = np.zeros(16, np.float32)
    c0 = native.calls["mio_encode_wav16"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [native.encode_wav16_native(audio, 8000)
                                                   for _ in range(300)]) for _ in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert native.calls["mio_encode_wav16"] == c0 + 24 * 300


# -- mp3 (ABI 6) --------------------------------------------------------------------------

def _voice(rate: int, secs: float = 0.5, nch: int = 1, seed: int = 0) -> np.ndarray:
    """A tone, noise and sharp bursts (long, short and start/stop blocks, a
    wide range of Huffman tables); ``nch`` 2 adds a right channel close to
    the left, which LAME codes mid/side in joint stereo."""
    rng = np.random.RandomState(seed)
    n = int(rate * secs)
    t = np.arange(n) / rate
    x = 0.2 * np.sin(2 * np.pi * 220 * t) + 0.08 * rng.randn(n)
    for k in range(3):
        p = n // 4 + k * n // 5
        m = min(200, n - p)
        x[p:p + m] += 0.6 * np.sin(2 * np.pi * min(3000, rate / 3) * np.arange(m) / rate)
    x = np.clip(x, -1, 1).astype(np.float32)
    if nch == 1:
        return x
    return np.stack([x, (0.9 * np.roll(x, 2) + 0.01 * rng.randn(n)).astype(np.float32)], 1)


def _first_frame(data: bytes) -> tuple[int, int]:
    """(bytes, samples) of the stream's first frame (a LAME stream starts
    with one)."""
    h1, h2 = data[1], data[2]
    v1 = (h1 >> 3) & 3 == 3
    rate = mp3.SAMPLE_RATES[(h1 >> 3) & 3][(h2 >> 2) & 3]
    bitrate = (mp3.BITRATES_V1 if v1 else mp3.BITRATES_V2)[(h2 >> 4) & 15] * 1000
    return (144 if v1 else 72) * bitrate // rate + ((h2 >> 1) & 1), 1152 if v1 else 576


def _tag_frame(data: bytes, tag: bytes) -> bytes:
    """``data`` led by a frame with its first frame's header, zero side
    info and ``tag`` at the main data (Xing) or 32 bytes after the header
    (VBRI), as a VBR encoder writes one."""
    n, _ = _first_frame(data)
    frame = bytearray(n)
    frame[:4] = data[:4]
    v1, mono = (data[1] >> 3) & 3 == 3, (data[3] >> 6) & 3 == 3
    at = 36 if tag == b"VBRI" else 4 + (17 if mono else 32) if v1 else 4 + (9 if mono else 17)
    frame[at:at + 4] = tag
    return bytes(frame) + data


# name -> (stream maker, a leading VBR header frame to skip, needs libmp3lame)
MP3_CASES = {
    "mpeg1_mono_44100": (lambda: lame_encode(_voice(44100), 44100, bitrate=128), False, True),
    "mpeg1_stereo_32000": (lambda: lame_encode(_voice(32000, nch=2), 32000, nch=2, bitrate=96,
                                               mode=0), False, True),
    "mpeg1_joint_48000": (lambda: lame_encode(_voice(48000, nch=2), 48000, nch=2, bitrate=160,
                                              mode=1), False, True),
    "mpeg2_mono_24000": (lambda: lame_encode(_voice(24000), 24000, bitrate=64), False, True),
    "mpeg2_joint_22050": (lambda: lame_encode(_voice(22050, nch=2), 22050, nch=2, bitrate=64,
                                              mode=1), False, True),
    "mpeg2_stereo_16000": (lambda: lame_encode(_voice(16000, nch=2), 16000, nch=2, bitrate=48,
                                               mode=0), False, True),
    "mpeg25_mono_11025": (lambda: lame_encode(_voice(11025), 11025, bitrate=32), False, True),
    "mpeg25_joint_12000": (lambda: lame_encode(_voice(12000, nch=2), 12000, nch=2, bitrate=32,
                                               mode=1), False, True),
    "mpeg25_mono_8000": (lambda: lame_encode(_voice(8000), 8000, bitrate=8), False, True),
    "crc_mpeg1": (lambda: lame_stream(_voice(44100), 44100, 128, crc=True), False, True),
    "crc_mpeg2": (lambda: lame_stream(_voice(22050), 22050, 64, crc=True), False, True),
    "lame_info_tag": (lambda: lame_stream(_voice(24000), 24000, 64, info_tag=True), True, True),
    "xing_tag": (lambda: _tag_frame(lame_encode(_voice(44100), 44100, bitrate=128), b"Xing"),
                 True, True),
    "vbri_tag": (lambda: _tag_frame(lame_encode(_voice(22050), 22050, bitrate=64), b"VBRI"),
                 True, True),
    # the committed fixtures: ref3.mp3 whole (LAME's Info frame in front); the
    # 20 s 44.1 kHz mid/side one cut to its first ~2 s (numpy takes ~8 s for all)
    "fixture_ref3": (lambda: (ASSETS / "ref3.mp3").read_bytes(), True, False),
    "fixture_ref20_441_joint_2s": (lambda: (ASSETS / "ref20_441_joint.mp3").read_bytes()[:32000],
                                   False, False),
}


def _mp3_params():
    return [pytest.param(name, marks=needs_oracles) if lame else name
            for name, (_, _, lame) in MP3_CASES.items()]


def _same_bits(got, want) -> None:
    assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype == np.float32 and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))


@pytest.mark.parametrize("case", _mp3_params())
def test_mp3_decode_native_matches_numpy(case):
    """Bit-equal samples and the same rate from the library and the port's
    numpy ``decode_mp3``, a leading Xing/Info/VBRI frame skipped by both;
    one probe and one decode counted."""
    data = MP3_CASES[case][0]()
    c0 = dict(native.calls)
    got = native.mp3_decode_native(data)
    assert got is not None and got[0].size > 0
    assert (native.calls["mio_mp3_probe"], native.calls["mio_mp3_decode"]) == (
        c0.get("mio_mp3_probe", 0) + 1, c0.get("mio_mp3_decode", 0) + 1)
    _same_bits(got, mp3.decode_mp3(data))


@pytest.mark.parametrize("case", _mp3_params())
def test_mp3_decode_native_matches_jax(case, monkeypatch):
    """Against JAX's native decoder (opt-in there: MIOTTS_NATIVE_MP3=1) and
    JAX's numpy decoder: bit-equal on an untagged stream; on a tagged one
    JAX decodes the tag frame as one frame of silence (ADVICE.md:5), which
    the port leaves out."""
    monkeypatch.setenv("MIOTTS_NATIVE_MP3", "1")
    data, tagged, _ = MP3_CASES[case]
    data = data()
    got = native.mp3_decode_native(data)
    for want in (jax_native.mp3_decode_native(data), jax_mp3.decode_mp3(data)):
        assert want is not None
        if tagged:
            skip = _first_frame(data)[1]
            assert not want[0][:skip].any()
            want = (want[0][skip:], want[1])
        _same_bits(got, want)


def test_mp3_fixture_whole_matches_jax_native(monkeypatch):
    """The whole 20 s 44.1 kHz mid/side fixture: bit-equal to JAX's native
    decode (the card's run holds it to numpy as well, chip_smoke.py
    [native])."""
    monkeypatch.setenv("MIOTTS_NATIVE_MP3", "1")
    data = (ASSETS / "ref20_441_joint.mp3").read_bytes()
    got = native.mp3_decode_native(data)
    assert got[1] == 44100 and got[0].size % 1152 == 0 and got[0].size >= 20 * 44100
    _same_bits(got, jax_native.mp3_decode_native(data))


def _seed_streams() -> list[bytes]:
    """~0.4 s of each committed fixture, cut at a frame boundary: MPEG-2 mono
    led by LAME's Info frame, and MPEG-1 joint stereo (mid/side)."""
    out = []
    for name, frames in (("ref3.mp3", 20), ("ref20_441_joint.mp3", 16)):
        data = (ASSETS / name).read_bytes()
        out.append(data[:frames * _first_frame(data)[0]])
    return out


def _mutated(kind: str, rng) -> bytes:
    seeds = _seed_streams()
    d = bytearray(seeds[rng.randint(len(seeds))])
    n = len(d)
    if kind == "truncated":
        return bytes(d[:rng.randint(1, n)])
    if kind == "bit_flipped":
        for _ in range(rng.randint(1, 40)):
            d[rng.randint(n)] ^= 1 << rng.randint(8)
    elif kind == "zero_filled":
        i, m = rng.randint(n), rng.randint(1, 600)
        d[i:i + m] = bytes(len(d[i:i + m]))
    elif kind == "spliced":
        other = seeds[rng.randint(len(seeds))]
        return bytes(d[:rng.randint(n)]) + other[rng.randint(len(other)):]
    elif kind == "garbage_filled":
        i, m = rng.randint(n), rng.randint(1, 400)
        d[i:i + m] = rng.randint(0, 256, len(d[i:i + m])).astype(np.uint8).tobytes()
    else:  # random bytes, some with a sync word at the front
        g = rng.randint(0, 256, rng.randint(0, 3000)).astype(np.uint8)
        if g.size > 4 and rng.randint(2):
            g[:4] = np.frombuffer(seeds[0][:4], np.uint8)
        return g.tobytes()
    return bytes(d)


MUTATIONS = ("truncated", "bit_flipped", "zero_filled", "spliced", "garbage_filled", "random")


@pytest.mark.parametrize("kind", MUTATIONS)
def test_mp3_mutated_streams_as_numpy(kind):
    """Eight seeded streams of each kind: the library answers None or
    numpy's answer (its rate and length, and its samples; a sample may sit
    one f32 step away, because the two decoders round their double sums in
    different orders: numpy's BLAS products and the C loops. Over 2 000
    such streams one sample in one stream did, ROADMAP §3)."""
    rng = np.random.RandomState(MUTATIONS.index(kind))
    for _ in range(8):
        data = _mutated(kind, rng)
        got = native.mp3_decode_native(data)
        try:
            want = mp3.decode_mp3(data)
        except ValueError:  # no decodable frame
            want = None
        if want is None or got is None:
            assert got is None
            continue
        assert got[1] == want[1] and got[0].shape == want[0].shape
        steps = np.abs(got[0].view(np.int32).astype(np.int64) - want[0].view(np.int32))
        assert steps.max(initial=0) <= 1


def test_mp3_decode_never_writes_past_cap():
    """A buffer of ``cap`` samples, valid and mutated streams: a decode that
    fills it returns -2 with exactly ``cap`` samples written, the guard
    words past it untouched; a decode into a big enough buffer returns 0
    and writes only what it reports."""
    lib = native._load()
    rng = np.random.RandomState(7)
    streams = _seed_streams() + [_mutated(k, rng) for k in MUTATIONS for _ in range(3)]
    guard = 64
    for data in streams:
        buf = np.frombuffer(data, np.uint8)
        info = np.zeros(4, np.int64)
        if lib.mio_mp3_probe(buf.ctypes.data, buf.size, info.ctypes.data) != 0:
            continue
        for cap in (1, 577, int(info[2]) // 3 + 1, int(info[2])):
            out = np.full(cap + guard, np.nan, np.float32)
            rc = lib.mio_mp3_decode(buf.ctypes.data, buf.size, out.ctypes.data, cap,
                                    info.ctypes.data)
            written = int(info[1])
            assert rc in (0, -1, -2)
            if rc == -2:
                assert written == cap
            if rc == 0:
                assert 0 < written <= cap and not np.isnan(out[:written]).any()
            assert np.isnan(out[cap:]).all() and np.isnan(out[max(written, 0):]).all()


@pytest.mark.parametrize("fault", ["garbage_between_frames", "frame_past_the_end"])
def test_mp3_scan_as_numpy(fault, monkeypatch):
    """The frame scan follows runtime/mp3.py: bytes that are no frame
    between two frames are skipped and the decode goes on (JAX's native
    decoder stops there, with a shorter answer than numpy's); a frame header
    whose frame runs past the stream's end ends the scan, so a stream that
    starts with one has no frame (JAX's scans on past it)."""
    monkeypatch.setenv("MIOTTS_NATIVE_MP3", "1")
    data = (ASSETS / "ref20_441_joint.mp3").read_bytes()[:40 * 418]
    n = _first_frame(data)[0]
    if fault == "garbage_between_frames":
        k = 10 * n + data[10 * n:].index(b"\xff\xfb", 1)  # the start of a later frame
        bad = data[:k] + bytes(range(1, 200)) + data[k:]
        got, want = native.mp3_decode_native(bad), mp3.decode_mp3(bad)
        _same_bits(got, want)
        _same_bits(got, native.mp3_decode_native(data))
        assert jax_native.mp3_decode_native(bad)[0].size < got[0].size
    else:
        bad = b"\xff\xfb\x90\x00" + bytes(40) + data  # 417 bytes claimed, 44 before data
        bad = bad[:300]
        assert native.mp3_decode_native(bad) is None
        with pytest.raises(ValueError):
            mp3.decode_mp3(bad)


@pytest.mark.parametrize("route", ["native", "numpy_env", "no_native"])
def test_load_audio_mp3(tmp_path, route, monkeypatch, request):
    """``load_audio`` on an mp3 goes native by default, to numpy under
    MIOTTS_NATIVE_MP3=0 or without the library; the same samples each way,
    resampled and cut alike; ``native.calls`` tells the route."""
    if route == "numpy_env":
        monkeypatch.setenv("MIOTTS_NATIVE_MP3", "0")
    elif route == "no_native":
        request.getfixturevalue("no_native")
    p = tmp_path / "ref.mp3"
    p.write_bytes((ASSETS / "ref3.mp3").read_bytes())
    want = mp3.decode_mp3(p.read_bytes())
    c0 = native.calls["mio_mp3_decode"]
    x, rate = audio_io.load_audio(p)
    _same_bits((x, rate), want)
    y, rate16 = audio_io.load_audio(p, target_rate=16000, max_seconds=1.5)
    assert rate16 == 16000
    np.testing.assert_array_equal(y, audio_io.resample_linear(want[0], 24000, 16000)[:24000])
    assert native.calls["mio_mp3_decode"] == c0 + (2 if route == "native" else 0)


def _header_arrays(path: Path) -> dict:
    import re

    text = path.read_text()
    return {m.group(2): (m.group(1), int(m.group(3)),
                         [int(v) for v in m.group(4).replace(",", " ").split()])
            for m in re.finditer(r"static const (\w+) (\w+)\[(\d+)\] = \{([^}]*)\};", text)}


def test_mp3_tables_header_matches_jax():
    """The port's generated mp3_tables.h holds JAX's arrays, value for
    value (type, name, length, values, order), and is what
    scripts/gen_torch_mp3_tables_h.py writes from the port's tables."""
    import importlib.util

    port = Path(native.__file__).parent / "native" / "mp3_tables.h"
    jax = Path(jax_native.__file__).parent / "native" / "mp3_tables.h"
    got, want = _header_arrays(port), _header_arrays(jax)
    assert len(got) == 17 and list(got) == list(want) and got == want
    assert all(length == len(vals) for _, length, vals in got.values())
    spec = importlib.util.spec_from_file_location(
        "gen_torch_mp3_tables_h",
        Path(__file__).resolve().parents[1] / "scripts" / "gen_torch_mp3_tables_h.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert gen.header() == port.read_text()
    assert port in build_native.HEADERS  # a changed table rebuilds the library
