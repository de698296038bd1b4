"""Self-contained FLAC decoder (pure Python + numpy), a copy of
miotts_tpu/runtime/flac.py held to it by tests/test_torch_clone.py.

The reference decodes reference-audio uploads with miniaudio, which
accepts wav/mp3/flac natively (wavlm-extractor.cpp:153-203). This module
gives the port a FLAC path with no optional dependency: a full RFC-9639
stream decoder — STREAMINFO, fixed/variable blocking,
constant/verbatim/fixed/LPC subframes, rice and escaped residual
partitions, left/side / right/side / mid/side decorrelation, wasted
bits. CRC-8/CRC-16 are parsed but not enforced (uploads are decoded
best-effort, matching miniaudio's default).

Speed: the rice hot loop walks a precomputed set-bit index (quotients)
and defers every remainder read into one vectorized gather per
partition. ``load_audio`` decodes FLAC with the native C++ decoder of
``native.py`` (``flac_decode_native``, the port's copy of the JAX
package's) first and with this module when that returns None; the two give
the same samples (tests/test_torch_native.py).
"""

from __future__ import annotations

import struct

import numpy as np

FIXED_COEFFS = {
    0: (),
    1: (1,),
    2: (2, -1),
    3: (3, -3, 1),
    4: (4, -6, 4, -1),
}

_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                 6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                 11: 96000}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class _Bits:
    """MSB-first bit reader over the whole stream, vectorized where the
    format allows (fixed-width fields, deferred rice remainders)."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0
        self._ones = np.empty(0, np.int64)  # set-bit positions cache
        self._ones_lo = 0
        self._ones_hi = 0
        self._ones_idx = 0

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        if n == 0:
            return 0
        chunk = self.bits[p:p + n].astype(np.int64)
        if chunk.size < n:
            raise EOFError("flac: truncated stream")
        return int(chunk @ (1 << np.arange(n - 1, -1, -1, dtype=np.int64)))

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if n and v >= (1 << (n - 1)) else v

    def read_signed_vec(self, n_bits: int, count: int) -> np.ndarray:
        """count signed n_bits-wide integers, fully vectorized."""
        if count == 0:
            return np.zeros(0, np.int64)
        if n_bits == 0:
            return np.zeros(count, np.int64)
        p = self.pos
        self.pos = p + n_bits * count
        if self.pos > self.bits.size:
            raise EOFError("flac: truncated stream")
        m = self.bits[p:self.pos].reshape(count, n_bits).astype(np.int64)
        v = m @ (1 << np.arange(n_bits - 1, -1, -1, dtype=np.int64))
        return v - (v >> (n_bits - 1)) * (1 << n_bits)

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def unary(self) -> int:
        """Count of 0-bits before the next 1-bit; consumes the 1."""
        one = self._next_one(self.pos)
        q = one - self.pos
        self.pos = one + 1
        return q

    def _next_one(self, p: int) -> int:
        # chunked set-bit index: extends in 4 Mbit windows so a frame's
        # worth of rice codes shares one flatnonzero pass
        while True:
            # the cached window always starts at or after any previously
            # scanned position, so entries are >= its lo even when p < lo
            if p < self._ones_hi:
                idx = self._ones_idx
                ones = self._ones
                while idx < ones.size and ones[idx] < p:
                    idx += 1
                self._ones_idx = idx
                if idx < ones.size:
                    return int(ones[idx])
            if self._ones_hi >= self.bits.size:
                raise EOFError("flac: truncated stream (unary)")
            lo = max(p, self._ones_hi)
            hi = min(self.bits.size, lo + (1 << 22))
            self._ones = lo + np.flatnonzero(self.bits[lo:hi]).astype(np.int64)
            self._ones_lo, self._ones_hi = lo, hi
            self._ones_idx = 0

    def read_rice_partition(self, k: int, n: int) -> np.ndarray:
        """n rice(k) codes: sequential unary quotients (pointer walk over
        the set-bit index), then ONE vectorized gather for all k-bit
        remainders."""
        quotients = np.empty(n, np.int64)
        rem_starts = np.empty(n, np.int64)
        p = self.pos
        for i in range(n):
            one = self._next_one(p)
            quotients[i] = one - p
            p = one + 1
            rem_starts[i] = p
            p += k
        self.pos = p
        if p > self.bits.size:
            raise EOFError("flac: truncated stream (rice)")
        if k:
            m = self.bits[(rem_starts[:, None]
                           + np.arange(k, dtype=np.int64)).reshape(-1)]
            rem = m.reshape(n, k).astype(np.int64) @ (
                1 << np.arange(k - 1, -1, -1, dtype=np.int64))
            v = (quotients << k) | rem
        else:
            v = quotients
        return (v >> 1) ^ -(v & 1)  # zigzag


def _read_utf8_coded(br: _Bits) -> int:
    """UTF-8-style variable-length coded frame/sample number."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n_cont = 0
    mask = 0x40
    while b0 & mask:
        n_cont += 1
        mask >>= 1
    if n_cont < 1 or n_cont > 6:
        raise ValueError("flac: invalid coded number")
    v = b0 & (mask - 1)
    for _ in range(n_cont):
        c = br.read(8)
        if (c & 0xC0) != 0x80:
            raise ValueError("flac: invalid coded number continuation")
        v = (v << 6) | (c & 0x3F)
    return v


def _decode_residual(br: _Bits, blocksize: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError(f"flac: reserved residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = br.read(4)
    n_part = 1 << po
    if blocksize % n_part:
        raise ValueError("flac: partition order does not divide blocksize")
    part_n = blocksize >> po
    if part_n <= order and n_part == 1:
        raise ValueError("flac: first partition has no samples")
    out = np.empty(blocksize - order, np.int64)
    w = 0
    for pi in range(n_part):
        n = part_n - (order if pi == 0 else 0)
        param = br.read(plen)
        if param == escape:
            nbits = br.read(5)
            vals = br.read_signed_vec(nbits, n)
        else:
            vals = br.read_rice_partition(param, n)
        out[w:w + n] = vals
        w += n
    return out


def _decode_subframe(br: _Bits, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("flac: subframe sync bit set")
    ftype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.unary() + 1
    eff = bps - wasted
    if ftype == 0:  # CONSTANT
        x = np.full(blocksize, br.read_signed(eff), np.int64)
    elif ftype == 1:  # VERBATIM
        x = br.read_signed_vec(eff, blocksize)
    elif 8 <= ftype <= 12:  # FIXED order 0-4
        order = ftype - 8
        warm = br.read_signed_vec(eff, order)
        res = _decode_residual(br, blocksize, order)
        x = _fixed_reconstruct(order, warm, res, blocksize)
    elif ftype >= 32:  # LPC
        order = (ftype & 31) + 1
        warm = br.read_signed_vec(eff, order)
        prec = br.read(4) + 1
        if prec == 16:
            raise ValueError("flac: invalid lpc precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("flac: negative lpc shift")
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        x = _lpc_reconstruct(warm, coefs, shift, res, blocksize)
    else:
        raise ValueError(f"flac: reserved subframe type {ftype}")
    if wasted:
        x = x << wasted
    return x


def _fixed_reconstruct(order: int, warm: np.ndarray, res: np.ndarray,
                       blocksize: int) -> np.ndarray:
    """Fixed predictors are nested integrations: order-o reconstruction is
    o cumulative sums over the residual seeded by the warmup's finite
    differences — fully vectorized (no per-sample Python loop)."""
    warm = warm.astype(np.int64)
    if order == 0:
        return res.copy()
    # seed: order-th differences of the warmup tail feed the first cumsum
    diffs = [warm]
    for _ in range(order):
        d = diffs[-1]
        diffs.append(np.diff(d) if d.size > 1 else np.zeros(0, np.int64))
    x = res
    for lvl in range(order, 0, -1):
        seed = diffs[lvl - 1][-1] if diffs[lvl - 1].size else 0
        x = seed + np.cumsum(x, dtype=np.int64)
    return np.concatenate([warm, x])


def _lpc_reconstruct(warm: np.ndarray, coefs: list[int], shift: int,
                     res: np.ndarray, blocksize: int) -> np.ndarray:
    # per-sample Python loop — the LPC recursion is inherently sequential;
    # Python ints keep the 64-bit accumulator semantics exact
    order = len(coefs)
    buf = list(map(int, warm))
    rl = res.tolist()
    for i in range(blocksize - order):
        base = i + order
        acc = 0
        for j in range(order):
            acc += coefs[j] * buf[base - 1 - j]
        buf.append(rl[i] + (acc >> shift))
    return np.asarray(buf, np.int64)


def parse_streaminfo(data: bytes) -> dict:
    """Parse the mandatory STREAMINFO block; raises on a non-FLAC stream."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    info = None
    while pos + 4 <= len(data):
        hdr = data[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        (blen,) = struct.unpack(">I", b"\0" + data[pos + 1:pos + 4])
        body = data[pos + 4:pos + 4 + blen]
        if btype == 0:
            raw = int.from_bytes(body[10:18], "big")
            info = {
                "min_block": struct.unpack(">H", body[0:2])[0],
                "max_block": struct.unpack(">H", body[2:4])[0],
                "sample_rate": raw >> 44,
                "channels": ((raw >> 41) & 0x7) + 1,
                "bps": ((raw >> 36) & 0x1F) + 1,
                "total_samples": raw & ((1 << 36) - 1),
                "data_offset": None,
            }
        pos += 4 + blen
        if last:
            break
    if info is None:
        raise ValueError("flac: missing STREAMINFO")
    info["data_offset"] = pos
    return info


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """Decode a FLAC stream to (f32 mono ndarray, sample_rate)."""
    info = parse_streaminfo(data)
    br = _Bits(data)
    br.pos = info["data_offset"] * 8
    chunks: list[np.ndarray] = []
    total = info["total_samples"]
    got = 0
    rate = info["sample_rate"]
    n_bits = br.bits.size
    while br.pos + 32 <= n_bits and (not total or got < total):
        frame, rate = _decode_frame(br, info)
        chunks.append(frame)
        got += frame.shape[1]
    if not chunks:
        return np.zeros(0, np.float32), rate or 16000
    samples = np.concatenate(chunks, axis=1)
    if total:
        samples = samples[:, :total]
    mono = samples.mean(axis=0)
    return (mono / float(1 << (info["bps"] - 1))).astype(np.float32), rate


def _decode_frame(br: _Bits, info: dict) -> tuple[np.ndarray, int]:
    sync = br.read(14)
    if sync != 0x3FFE:
        raise ValueError(f"flac: lost frame sync at bit {br.pos - 14}")
    if br.read(1):
        raise ValueError("flac: reserved frame bit set")
    br.read(1)  # blocking strategy
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    if br.read(1):
        raise ValueError("flac: reserved frame bit set")
    _read_utf8_coded(br)
    if bs_code == 0:
        raise ValueError("flac: reserved block size code")
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = _BLOCK_SIZES[bs_code]
    if sr_code == 0:
        rate = info["sample_rate"]
    elif sr_code == 12:
        rate = br.read(8) * 1000
    elif sr_code == 13:
        rate = br.read(16)
    elif sr_code == 14:
        rate = br.read(16) * 10
    elif sr_code == 15:
        raise ValueError("flac: invalid sample rate code")
    else:
        rate = _SAMPLE_RATES[sr_code]
    bps = info["bps"] if ss_code == 0 else _SAMPLE_SIZES.get(ss_code)
    if bps is None:
        raise ValueError("flac: reserved sample size code")
    br.read(8)  # header CRC-8 (not enforced)

    if ch_code <= 7:
        n_ch = ch_code + 1
        chans = [_decode_subframe(br, blocksize, bps) for _ in range(n_ch)]
        out = np.stack(chans)
    elif ch_code in (8, 9, 10):
        side_idx = 1 if ch_code in (8, 10) else 0
        chans = [
            _decode_subframe(br, blocksize,
                             bps + (1 if i == side_idx else 0))
            for i in range(2)
        ]
        if ch_code == 8:  # left/side
            left = chans[0]
            right = left - chans[1]
        elif ch_code == 9:  # right/side
            right = chans[1]
            left = chans[0] + right
        else:  # mid/side
            mid, side = chans
            mid2 = (mid << 1) | (side & 1)
            left = (mid2 + side) >> 1
            right = (mid2 - side) >> 1
        out = np.stack([left, right])
    else:
        raise ValueError(f"flac: reserved channel assignment {ch_code}")
    br.align()
    br.read(16)  # frame CRC-16 (not enforced)
    return out, rate
