"""GGML tensor dtypes + vectorized numpy dequantization
(miotts_tpu/gguf/quants.py), and the Q8_0/Q4_0 block quantizers the
synthetic writers use (miotts_tpu/runtime/native.py:292-305, :367-387).

Supports the types that appear in the MioTTS model zoo: F32/F16/BF16 for the
codec/WavLM GGUFs (converters emit f32: ``convert_miocodec_to_gguf.py:390``),
Q8_0 / Q4_0 / Q4_1 / Q5_0 / Q5_1 / Q6_K / Q4_K for the quantized LLM GGUF
(MioTTS-0.1B-Q8_0), and I8/I16/I32/I64/F64 for metadata tensors such as
``miocodec.wave_upsampler.factors`` (i32, ``miocodec-decoder.cpp:577-600``).
``dequantize`` takes the threaded native dequant of ``runtime/native.py``
first for every non-F32 tensor of at least 2^16 elements, as the JAX
package does, and numpy otherwise or when the library is unavailable. Both
give the same values; the native route returns F16/BF16 as float32, where
numpy returns an F16 tensor as a float16 view.
"""

from __future__ import annotations

import enum

import numpy as np


class GGMLType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    BF16 = 30


# (block_size_elements, bytes_per_block); simple types use block size 1.
GGML_TYPE_TRAITS: dict[int, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 18),
    GGMLType.Q4_1: (32, 20),
    GGMLType.Q5_0: (32, 22),
    GGMLType.Q5_1: (32, 24),
    GGMLType.Q8_0: (32, 34),
    GGMLType.Q4_K: (256, 144),
    GGMLType.Q5_K: (256, 176),
    GGMLType.Q6_K: (256, 210),
}


def type_nbytes(ggml_type: int, n_elements: int) -> int:
    block, nbytes = GGML_TYPE_TRAITS[ggml_type]
    if n_elements % block != 0:
        raise ValueError(f"n_elements {n_elements} not divisible by block {block}")
    return (n_elements // block) * nbytes


def _dequant_q8_0(raw: np.ndarray, n: int) -> np.ndarray:
    # block: f16 scale d, 32 × int8 quants; value = d * q
    blocks = raw.reshape(-1, 34)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)  # [nb, 1]
    q = blocks[:, 2:].copy().view(np.int8).astype(np.float32)  # [nb, 32]
    return (d * q).reshape(-1)[:n]


def _dequant_q4_0(raw: np.ndarray, n: int) -> np.ndarray:
    # block: f16 d, 16 bytes of 4-bit quants (two nibbles per byte); v = d*(q-8)
    blocks = raw.reshape(-1, 18)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    qs = blocks[:, 2:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)  # [nb, 32]
    return (d * q).reshape(-1)[:n]


def _dequant_q4_1(raw: np.ndarray, n: int) -> np.ndarray:
    # block: f16 d, f16 m, 16 bytes nibbles; v = d*q + m
    blocks = raw.reshape(-1, 20)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    qs = blocks[:, 4:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.concatenate([lo, hi], axis=1)
    return (d * q + m).reshape(-1)[:n]


def _dequant_q5_0(raw: np.ndarray, n: int) -> np.ndarray:
    # block: f16 d, u32 qh (high bits), 16 bytes nibbles; v = d*(q-16)
    blocks = raw.reshape(-1, 22)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    qh = blocks[:, 2:6].copy().view(np.uint32)  # [nb, 1]
    qs = blocks[:, 6:]
    shifts = np.arange(32, dtype=np.uint32)
    hbits = ((qh >> shifts[None, :]) & 1).astype(np.uint8)  # [nb, 32]
    lo = (qs & 0x0F).astype(np.uint8) | (hbits[:, :16] << 4)
    hi = (qs >> 4).astype(np.uint8) | (hbits[:, 16:] << 4)
    q = np.concatenate([lo, hi], axis=1).astype(np.float32) - 16.0
    return (d * q).reshape(-1)[:n]


def _dequant_q5_1(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 24)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    qh = blocks[:, 4:8].copy().view(np.uint32)
    qs = blocks[:, 8:]
    shifts = np.arange(32, dtype=np.uint32)
    hbits = ((qh >> shifts[None, :]) & 1).astype(np.uint8)
    lo = (qs & 0x0F).astype(np.uint8) | (hbits[:, :16] << 4)
    hi = (qs >> 4).astype(np.uint8) | (hbits[:, 16:] << 4)
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (d * q + m).reshape(-1)[:n]


def _dequant_q6_k(raw: np.ndarray, n: int) -> np.ndarray:
    # super-block of 256: ql[128] (low 4 bits), qh[64] (high 2 bits),
    # scales[16] int8, d f16; v = d * scale[i//16] * (q - 32)
    blocks = raw.reshape(-1, 210)
    nb = blocks.shape[0]
    ql = blocks[:, :128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].copy().view(np.int8).astype(np.float32)  # [nb,16]
    d = blocks[:, 208:210].copy().view(np.float16).astype(np.float32)  # [nb,1]

    q = np.empty((nb, 256), dtype=np.float32)
    # layout follows ggml dequantize_row_q6_K: two 128-halves per superblock;
    # within a half: low nibbles of ql[0:32]/ql[32:64] then high nibbles,
    # with 2-bit high parts taken from successive bit-pairs of qh[0:32].
    for half in range(2):
        ql_h = ql[:, half * 64:(half + 1) * 64]
        qh_h = qh[:, half * 32:(half + 1) * 32]
        base = half * 128
        q[:, base + 0:base + 32] = ((ql_h[:, 0:32] & 0x0F) | (((qh_h >> 0) & 3) << 4)).astype(np.int16) - 32
        q[:, base + 32:base + 64] = ((ql_h[:, 32:64] & 0x0F) | (((qh_h >> 2) & 3) << 4)).astype(np.int16) - 32
        q[:, base + 64:base + 96] = ((ql_h[:, 0:32] >> 4) | (((qh_h >> 4) & 3) << 4)).astype(np.int16) - 32
        q[:, base + 96:base + 128] = ((ql_h[:, 32:64] >> 4) | (((qh_h >> 6) & 3) << 4)).astype(np.int16) - 32
    # each of the 16 int8 scales covers 16 consecutive output elements
    scale_per_elem = np.repeat(sc, 16, axis=1)  # [nb, 256]
    return (d * scale_per_elem * q).reshape(-1)[:n]


def _unpack_q4k_scales(scales_raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    # 12 bytes -> 8 six-bit (scale, min) pairs, ggml get_scale_min_k4 layout
    sb = scales_raw.astype(np.uint8)
    sc = np.empty(sb.shape[:-1] + (8,), dtype=np.float32)
    mn = np.empty_like(sc)
    for j in range(8):
        if j < 4:
            sc[..., j] = (sb[..., j] & 63).astype(np.float32)
            mn[..., j] = (sb[..., j + 4] & 63).astype(np.float32)
        else:
            sc[..., j] = ((sb[..., j + 4] & 0x0F) | ((sb[..., j - 4] >> 6) << 4)).astype(np.float32)
            mn[..., j] = ((sb[..., j + 4] >> 4) | ((sb[..., j] >> 6) << 4)).astype(np.float32)
    return sc, mn


def _dequant_q4_k(raw: np.ndarray, n: int) -> np.ndarray:
    # super-block 256: d f16, dmin f16, scales[12], qs[128]
    blocks = raw.reshape(-1, 144)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _unpack_q4k_scales(blocks[:, 4:16])
    qs = blocks[:, 16:]
    nb = blocks.shape[0]
    out = np.empty((nb, 256), dtype=np.float32)
    for j in range(4):  # 4 groups of 64 elements = 32 bytes each
        b = qs[:, j * 32:(j + 1) * 32]
        lo = (b & 0x0F).astype(np.float32)
        hi = (b >> 4).astype(np.float32)
        ds1 = d * sc[:, 2 * j:2 * j + 1]
        m1 = dmin * mn[:, 2 * j:2 * j + 1]
        ds2 = d * sc[:, 2 * j + 1:2 * j + 2]
        m2 = dmin * mn[:, 2 * j + 1:2 * j + 2]
        out[:, j * 64:j * 64 + 32] = ds1 * lo - m1
        out[:, j * 64 + 32:j * 64 + 64] = ds2 * hi - m2
    return out.reshape(-1)[:n]


def _dequant_q5_k(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 176)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _unpack_q4k_scales(blocks[:, 4:16])
    qh = blocks[:, 16:48]
    qs = blocks[:, 48:]
    nb = blocks.shape[0]
    out = np.empty((nb, 256), dtype=np.float32)
    u1 = 1
    for j in range(4):
        b = qs[:, j * 32:(j + 1) * 32]
        h1 = ((qh & u1) != 0).astype(np.float32) * 16.0
        h2 = ((qh & (u1 << 1)) != 0).astype(np.float32) * 16.0
        lo = (b & 0x0F).astype(np.float32) + h1
        hi = (b >> 4).astype(np.float32) + h2
        ds1 = d * sc[:, 2 * j:2 * j + 1]
        m1 = dmin * mn[:, 2 * j:2 * j + 1]
        ds2 = d * sc[:, 2 * j + 1:2 * j + 2]
        m2 = dmin * mn[:, 2 * j + 1:2 * j + 2]
        out[:, j * 64:j * 64 + 32] = ds1 * lo - m1
        out[:, j * 64 + 32:j * 64 + 64] = ds2 * hi - m2
        u1 <<= 2
    return out.reshape(-1)[:n]


_SIMPLE_DTYPES = {
    GGMLType.F32: np.dtype("<f4"),
    GGMLType.F64: np.dtype("<f8"),
    GGMLType.F16: np.dtype("<f2"),
    GGMLType.I8: np.dtype("<i1"),
    GGMLType.I16: np.dtype("<i2"),
    GGMLType.I32: np.dtype("<i4"),
    GGMLType.I64: np.dtype("<i8"),
}

_QUANT_DEQUANT = {
    GGMLType.Q8_0: _dequant_q8_0,
    GGMLType.Q4_0: _dequant_q4_0,
    GGMLType.Q4_1: _dequant_q4_1,
    GGMLType.Q5_0: _dequant_q5_0,
    GGMLType.Q5_1: _dequant_q5_1,
    GGMLType.Q6_K: _dequant_q6_k,
    GGMLType.Q4_K: _dequant_q4_k,
    GGMLType.Q5_K: _dequant_q5_k,
}


def dequantize(raw: np.ndarray, ggml_type: int, n_elements: int) -> np.ndarray:
    """Dequantize raw bytes of a GGML tensor into a flat numpy array.

    Simple float/int types are returned as views in their native dtype
    (caller reshapes); quantized types are expanded to float32. Large
    tensors use the threaded native kernel when the runtime library is
    available (runtime/native.py), which expands F16/BF16 to float32 too."""
    ggml_type = GGMLType(ggml_type)
    if n_elements >= 1 << 16 and ggml_type != GGMLType.F32:
        from ..runtime.native import dequantize_native

        out = dequantize_native(raw, int(ggml_type), n_elements)
        if out is not None:
            return out
    return dequantize_numpy(raw, ggml_type, n_elements)


def dequantize_numpy(raw: np.ndarray, ggml_type: int, n_elements: int) -> np.ndarray:
    """``dequantize``'s numpy route, whatever the size."""
    ggml_type = GGMLType(ggml_type)
    if ggml_type in _SIMPLE_DTYPES:
        return raw.view(_SIMPLE_DTYPES[ggml_type])[:n_elements]
    if ggml_type == GGMLType.BF16:
        u16 = raw.view(np.uint16)[:n_elements].astype(np.uint32) << 16
        return u16.view(np.float32)
    fn = _QUANT_DEQUANT.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"dequantization for {ggml_type!r} not implemented")
    return fn(np.ascontiguousarray(raw), n_elements)


def q8_quantize_weights(w: np.ndarray) -> np.ndarray:
    """f32 [N, K] -> raw Q8_0 block bytes (synthetic/converted models; real
    MioTTS GGUFs carry Q8_0 payloads already)."""
    n, k = w.shape
    assert k % 32 == 0
    blocks = w.reshape(n, k // 32, 32).astype(np.float32)
    amax = np.abs(blocks).max(axis=2)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.rint(blocks * inv[:, :, None]).astype(np.int8)
    out = np.empty((n, k // 32, 34), np.uint8)
    out[:, :, :2] = d.astype(np.float16).view(np.uint8).reshape(n, k // 32, 2)
    out[:, :, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def q4_quantize_weights(w: np.ndarray) -> np.ndarray:
    """f32 [N, K] -> raw Q4_0 block bytes (llama.cpp quantize_row_q4_0
    arithmetic: scale from the max-|x| element SIGNED value / -8, nibbles
    biased +8)."""
    n, k = w.shape
    assert k % 32 == 0
    blocks = w.reshape(n, k // 32, 32).astype(np.float32)
    # value (signed) at the position of max |x| per block
    idx = np.abs(blocks).argmax(axis=2)
    vmax = np.take_along_axis(blocks, idx[:, :, None], axis=2)[:, :, 0]
    d = (vmax / -8.0).astype(np.float32)
    # store/read the scale as f16 exactly as the kernel will see it
    d16 = d.astype(np.float16)
    df = d16.astype(np.float32)
    inv = np.where(df != 0, 1.0 / np.where(df == 0, 1, df), 0.0)
    q = np.clip(np.floor(blocks * inv[:, :, None] + 8.5), 0, 15).astype(
        np.uint8)
    out = np.empty((n, k // 32, 18), np.uint8)
    out[:, :, :2] = d16.view(np.uint8).reshape(n, k // 32, 2)
    out[:, :, 2:] = q[:, :, :16] | (q[:, :, 16:] << 4)
    return out.reshape(-1)
