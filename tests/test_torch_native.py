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
(bit-equal to JAX's native, within 1e-6 of numpy's ``resample_linear``).
Skipped only where no C++ compiler can build the library."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from flac_encoder import encode_flac  # noqa: E402

from miotts_tpu.gguf import quants as jax_quants  # noqa: E402
from miotts_tpu.runtime import audio_io as jax_audio  # noqa: E402
from miotts_tpu.runtime import native as jax_native  # noqa: E402
from miotts_tpu_torch.gguf import quants  # noqa: E402
from miotts_tpu_torch.gguf.quants import GGMLType  # noqa: E402
from miotts_tpu_torch.runtime import audio_io, build_native, flac, native  # noqa: E402

pytestmark = pytest.mark.skipif(build_native.compiler() is None,
                                reason="no C++ compiler (g++ or clang++) to build the native library")

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
    """ABI 5, the port's own file beside JAX's, no mp3 entry point."""
    lib = native._load()
    assert native.available() and lib is not None and native.unavailable_reason() == ""
    assert lib.mio_runtime_abi_version() == 5
    assert lib._name != jax_native._load()._name
    assert native.NATIVE_DEQUANT_TYPES == jax_native.NATIVE_DEQUANT_TYPES
    assert not hasattr(lib, "mio_mp3_decode") and not hasattr(native, "mp3_decode_native")
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
    assert dict(native.calls) == before


def test_native_routes_import_no_jax(tmp_path):
    """In a fresh interpreter the library loads, and a FLAC decode, a large
    dequant and a WAV encode go native, with no ``jax`` or ``miotts_tpu``
    module imported."""
    import subprocess

    p = tmp_path / "a.flac"
    p.write_bytes(FLAC_CASES["lpc2"]())
    probe = f"""
import sys
import numpy as np
from miotts_tpu_torch.gguf.quants import dequantize
from miotts_tpu_torch.runtime import audio_io, native
x, rate = audio_io.load_audio({str(p)!r})
w = dequantize(np.zeros(1 << 17, np.uint16).view(np.uint8), 1, 1 << 17)
wav = audio_io.encode_wav16(x, rate)
assert native.available() and w.dtype == np.float32, native.unavailable_reason()
assert {{k: native.calls[k] for k in ("mio_flac_decode", "mio_dequant", "mio_encode_wav16")}} \\
    == {{"mio_flac_decode": 1, "mio_dequant": 1, "mio_encode_wav16": 1}}, native.calls
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
