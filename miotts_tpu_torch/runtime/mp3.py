"""Self-contained MPEG-1/2/2.5 Layer III (mp3) decoder in numpy, a copy
of miotts_tpu/runtime/mp3.py held to it by tests/test_torch_clone.py.

It decodes reference-audio uploads with no external dependency, as the
reference's miniaudio surface does (wavlm-extractor.cpp:153-203 accepts
wav/mp3/flac uploads). The constant tables (ISO 11172-3 B.7 Huffman
codebooks, B.3 synthesis window, B.8 scalefactor bands) live in
mp3_tables.py / below; the decode pipeline is LUT-based Huffman over the
bit reservoir, vectorized requantize/IMDCT (matmul formulation), and a
numpy polyphase synthesis.

Supports: MPEG-1/2/2.5 Layer III, mono/stereo/joint (MS + intensity),
long/short/mixed blocks, CRC frames (skipped, not checked), the bit
reservoir, and free-position sync scan with ID3v2 skip. Not supported:
Layer I/II, free-format bitrate.

One deliberate difference from the original: a stream's first frame whose
main data starts with a ``Xing`` or ``Info`` tag, or which carries
``VBRI`` 32 bytes after its header (the VBR/LAME header frames), is
metadata and is skipped, not decoded as audio. The original decodes it,
so a LAME file gains one frame of leading silence there (1 152 samples
for MPEG-1, 576 for MPEG-2/2.5); otherwise the two decode bit-equal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .mp3_tables import (CODE_OF, COUNT1A_COD, COUNT1A_LEN, HUFF_BIG,
                         LINBITS, SYNTH_WIN_BASE)

# ---------------------------------------------------------------------------
# constant tables (ISO 11172-3 / 13818-3)
# ---------------------------------------------------------------------------

SAMPLE_RATES = {3: (44100, 48000, 32000),   # MPEG1
                2: (22050, 24000, 16000),   # MPEG2
                0: (11025, 12000, 8000)}    # MPEG2.5
BITRATES_V1 = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128,
               160, 192, 224, 256, 320)
BITRATES_V2 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160)

# scalefactor band boundaries (Table B.8): rate -> (long[23], short[14])
SFB = {
    44100: ([0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134,
             162, 196, 238, 288, 342, 418, 576],
            [0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192]),
    48000: ([0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106, 128,
             156, 190, 230, 276, 330, 384, 576],
            [0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192]),
    32000: ([0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126, 156,
             194, 240, 296, 364, 448, 550, 576],
            [0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192]),
    22050: ([0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168,
             200, 238, 284, 336, 396, 464, 522, 576],
            [0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192]),
    24000: ([0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 114, 136, 162,
             194, 232, 278, 332, 394, 464, 540, 576],
            [0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192]),
    16000: ([0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168,
             200, 238, 284, 336, 396, 464, 522, 576],
            [0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192]),
    11025: ([0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168,
             200, 238, 284, 336, 396, 464, 522, 576],
            [0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192]),
    12000: ([0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168,
             200, 238, 284, 336, 396, 464, 522, 576],
            [0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192]),
    8000: ([0, 12, 24, 36, 48, 60, 72, 88, 108, 132, 160, 192, 232, 280,
            336, 400, 476, 566, 568, 570, 572, 574, 576],
           [0, 8, 16, 24, 36, 52, 72, 96, 124, 160, 162, 164, 166, 192]),
}

PRETAB = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                   1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0], np.int32)
SLEN1 = (0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4)
SLEN2 = (0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3)

# LSF scalefactor partition (13818-3): [blocknum][cls][4] band counts,
# cls: 0 long, 1 short, 2 mixed
NR_OF_SFB = (
    ((6, 5, 5, 5), (9, 9, 9, 9), (6, 9, 9, 9)),
    ((6, 5, 7, 3), (9, 9, 12, 6), (6, 9, 12, 6)),
    ((11, 10, 0, 0), (18, 18, 0, 0), (15, 18, 0, 0)),
    ((7, 7, 7, 0), (12, 12, 12, 0), (6, 15, 12, 0)),
    ((6, 6, 6, 3), (12, 9, 9, 6), (6, 12, 9, 6)),
    ((8, 8, 5, 0), (15, 12, 9, 0), (6, 18, 9, 0)),
)

_CI = (-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037)
_CS = np.array([1.0 / math.sqrt(1.0 + c * c) for c in _CI])
_CA = np.array([c / math.sqrt(1.0 + c * c) for c in _CI])


def _imdct_matrix(n: int) -> np.ndarray:
    """[n, n//2] IMDCT basis: x[i] = sum_k X[k] cos(pi/2n (2i+1+n/2)(2k+1))."""
    i = np.arange(n)[:, None]
    k = np.arange(n // 2)[None, :]
    return np.cos(np.pi / (2 * n) * (2 * i + 1 + n // 2) * (2 * k + 1))


_IMDCT36 = _imdct_matrix(36)
_IMDCT12 = _imdct_matrix(12)

_WIN = np.zeros((4, 36))
_i = np.arange(36)
_WIN[0] = np.sin(np.pi / 36 * (_i + 0.5))
_WIN[1, :18] = np.sin(np.pi / 36 * (_i[:18] + 0.5))
_WIN[1, 18:24] = 1.0
_WIN[1, 24:30] = np.sin(np.pi / 12 * (_i[24:30] - 18 + 0.5))
_WIN[3, 6:12] = np.sin(np.pi / 12 * (_i[6:12] - 6 + 0.5))
_WIN[3, 12:18] = 1.0
_WIN[3, 18:] = np.sin(np.pi / 36 * (_i[18:] + 0.5))
_WIN12 = np.sin(np.pi / 12 * (np.arange(12) + 0.5))

# synthesis matrixing N[i,k] = cos((16+i)(2k+1) pi/64), i=0..63
_NMAT = np.cos((16 + np.arange(64))[:, None]
               * (2 * np.arange(32)[None, :] + 1) * np.pi / 64)

# full 512-tap synthesis window from the 257-value base:
# D[i] = base[i] (i <= 256) / base[512-i] (i > 256), sign-flipped every 64
# taps. Derived by exact least-squares recovery against libmpg123 output
# (residual 1e-13, every tap integer on the spec's 1/65536 grid); the 8
# taps at i = 16 mod 64 multiply structurally-zero filterbank lines.
_DWIN = np.empty(512)
_base = np.asarray(SYNTH_WIN_BASE, np.float64) / 65536.0
_DWIN[:257] = _base
_DWIN[257:] = _base[1:256][::-1]
_DWIN *= np.where((np.arange(512) // 64) % 2 == 1, -1.0, 1.0)

_POW43 = np.arange(8207, dtype=np.float64) ** (4.0 / 3.0)


# ---------------------------------------------------------------------------
# Huffman LUTs
# ---------------------------------------------------------------------------

_LUT_CACHE: dict[str, tuple[np.ndarray, int]] = {}


def _big_lut(key: str) -> tuple[np.ndarray, int]:
    """Flat LUT: index by the next maxlen bits -> packed (x<<12|y<<8|hlen)."""
    if key in _LUT_CACHE:
        return _LUT_CACHE[key]
    xlen, ylen, lens, codes = HUFF_BIG[key]
    maxlen = max(lens)
    lut = np.zeros(1 << maxlen, np.int32)
    for i, (l, c) in enumerate(zip(lens, codes)):
        x, y = i // ylen, i % ylen
        base = c << (maxlen - l)
        lut[base:base + (1 << (maxlen - l))] = (x << 12) | (y << 8) | l
    _LUT_CACHE[key] = (lut, maxlen)
    return lut, maxlen


def _count1_lut(table_b: bool) -> tuple[np.ndarray, int]:
    key = "c1B" if table_b else "c1A"
    if key in _LUT_CACHE:
        return _LUT_CACHE[key]
    if table_b:
        lens = [4] * 16
        codes = [15 - i for i in range(16)]
    else:
        lens, codes = COUNT1A_LEN, COUNT1A_COD
    maxlen = max(lens)
    lut = np.zeros(1 << maxlen, np.int32)
    for i, (l, c) in enumerate(zip(lens, codes)):
        base = c << (maxlen - l)
        lut[base:base + (1 << (maxlen - l))] = (i << 8) | l
    _LUT_CACHE[key] = (lut, maxlen)
    return lut, maxlen


class _Bits:
    """MSB-first bit reader over a bytes-like object."""

    __slots__ = ("data", "pos")

    def __init__(self, data, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        byte0 = p >> 3
        nbytes = ((p & 7) + n + 7) >> 3
        chunk = bytes(self.data[byte0:byte0 + nbytes])
        if len(chunk) < nbytes:
            chunk = chunk + b"\x00" * (nbytes - len(chunk))
        v = int.from_bytes(chunk, "big")
        drop = 8 * nbytes - (p & 7) - n
        return (v >> drop) & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        p = self.pos
        v = self.get(n)
        self.pos = p
        return v


# ---------------------------------------------------------------------------
# frame / side-info parsing
# ---------------------------------------------------------------------------

@dataclass
class _Granule:
    part2_3_length: int = 0
    big_values: int = 0
    global_gain: int = 0
    scalefac_compress: int = 0
    window_switching: bool = False
    block_type: int = 0
    mixed_block: bool = False
    table_select: tuple = (0, 0, 0)
    subblock_gain: tuple = (0, 0, 0)
    region0_count: int = 0
    region1_count: int = 0
    preflag: int = 0
    scalefac_scale: int = 0
    count1table_select: int = 0
    # filled during decode
    scalefac_l: np.ndarray = field(default=None, repr=False)
    scalefac_s: np.ndarray = field(default=None, repr=False)


@dataclass
class _Frame:
    version: int  # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
    rate: int
    nch: int
    mode: int
    mode_ext: int
    main_data_begin: int
    scfsi: list  # [ch][4] (MPEG1 only)
    granules: list  # [gr][ch] -> _Granule
    main: bytes
    tag: bool = False  # a Xing/Info/VBRI header frame


def _parse_frames(data: bytes):
    """Scan the stream, yield parsed _Frame objects."""
    pos = 0
    if data[:3] == b"ID3" and len(data) >= 10:
        size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) \
            | ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
        pos = 10 + size
    n = len(data)
    while pos + 4 <= n:
        if not (data[pos] == 0xFF and (data[pos + 1] & 0xE0) == 0xE0):
            pos += 1
            continue
        h1, h2, h3 = data[pos + 1], data[pos + 2], data[pos + 3]
        version = (h1 >> 3) & 3
        layer = (h1 >> 1) & 3
        crc = not (h1 & 1)
        br_idx = (h2 >> 4) & 15
        sr_idx = (h2 >> 2) & 3
        padding = (h2 >> 1) & 1
        mode = (h3 >> 6) & 3
        mode_ext = (h3 >> 4) & 3
        if version == 1 or layer != 1 or br_idx in (0, 15) or sr_idx == 3:
            pos += 1
            continue
        rate = SAMPLE_RATES[version][sr_idx]
        v1 = version == 3
        bitrate = (BITRATES_V1 if v1 else BITRATES_V2)[br_idx] * 1000
        frame_len = (144 if v1 else 72) * bitrate // rate + padding
        if frame_len < 24 or pos + frame_len > n:
            # tolerate a truncated final frame: stop cleanly
            if pos + frame_len > n:
                return
            pos += 1
            continue
        nch = 1 if mode == 3 else 2
        off = pos + 4 + (2 if crc else 0)
        si_len = (17 if nch == 1 else 32) if v1 else (9 if nch == 1 else 17)
        br = _Bits(data[off:off + si_len])
        try:
            fr = _parse_side_info(br, v1, nch)
        except Exception:
            pos += 1
            continue
        fr.version = version
        fr.rate = rate
        fr.nch = nch
        fr.mode = mode
        fr.mode_ext = mode_ext
        fr.main = data[off + si_len:pos + frame_len]
        fr.tag = (fr.main[:4] in (b"Xing", b"Info")
                  or data[pos + 36:pos + 40] == b"VBRI")
        yield fr
        pos += frame_len


def _parse_side_info(br: _Bits, v1: bool, nch: int) -> _Frame:
    mdb = br.get(9 if v1 else 8)
    br.get((5 if nch == 1 else 3) if v1 else (1 if nch == 1 else 2))
    scfsi = [[0] * 4 for _ in range(nch)]
    if v1:
        for ch in range(nch):
            for b in range(4):
                scfsi[ch][b] = br.get(1)
    ngr = 2 if v1 else 1
    granules = []
    for _gr in range(ngr):
        chs = []
        for _ch in range(nch):
            g = _Granule()
            g.part2_3_length = br.get(12)
            g.big_values = br.get(9)
            g.global_gain = br.get(8)
            g.scalefac_compress = br.get(4 if v1 else 9)
            g.window_switching = bool(br.get(1))
            if g.window_switching:
                g.block_type = br.get(2)
                g.mixed_block = bool(br.get(1))
                g.table_select = (br.get(5), br.get(5), 0)
                g.subblock_gain = (br.get(3), br.get(3), br.get(3))
                # implied region split (libmad/dist10 convention)
                g.region0_count = 8 if (g.block_type == 2
                                        and not g.mixed_block) else 7
                g.region1_count = 36
            else:
                g.table_select = (br.get(5), br.get(5), br.get(5))
                g.region0_count = br.get(4)
                g.region1_count = br.get(3)
                g.block_type = 0
            if v1:
                g.preflag = br.get(1)
            g.scalefac_scale = br.get(1)
            g.count1table_select = br.get(1)
            chs.append(g)
        granules.append(chs)
    return _Frame(version=0, rate=0, nch=nch, mode=0, mode_ext=0,
                  main_data_begin=mdb, scfsi=scfsi, granules=granules,
                  main=b"")


# ---------------------------------------------------------------------------
# scalefactors
# ---------------------------------------------------------------------------

def _read_scalefacs_v1(br: _Bits, g: _Granule, gr: int, scfsi,
                       prev: _Granule | None) -> None:
    s1, s2 = SLEN1[g.scalefac_compress], SLEN2[g.scalefac_compress]
    short = g.window_switching and g.block_type == 2
    if short and not g.mixed_block:
        sf = np.zeros((13, 3), np.int32)
        for sfb in range(6):
            for w in range(3):
                sf[sfb, w] = br.get(s1)
        for sfb in range(6, 12):
            for w in range(3):
                sf[sfb, w] = br.get(s2)
        g.scalefac_s = sf
        g.scalefac_l = np.zeros(22, np.int32)
    elif short:  # mixed
        sl = np.zeros(22, np.int32)
        for sfb in range(8):
            sl[sfb] = br.get(s1)
        sf = np.zeros((13, 3), np.int32)
        for sfb in range(3, 6):
            for w in range(3):
                sf[sfb, w] = br.get(s1)
        for sfb in range(6, 12):
            for w in range(3):
                sf[sfb, w] = br.get(s2)
        g.scalefac_l = sl
        g.scalefac_s = sf
    else:
        sl = np.zeros(22, np.int32)
        groups = ((0, 6, s1), (6, 11, s1), (11, 16, s2), (16, 21, s2))
        for gi, (a, b, sl_bits) in enumerate(groups):
            if gr == 1 and scfsi[gi] and prev is not None:
                sl[a:b] = prev.scalefac_l[a:b]
            else:
                for sfb in range(a, b):
                    sl[sfb] = br.get(sl_bits)
        g.scalefac_l = sl
        g.scalefac_s = np.zeros((13, 3), np.int32)


def _read_scalefacs_lsf(br: _Bits, g: _Granule, intensity_ch: bool) -> None:
    sfc = g.scalefac_compress
    g.preflag = 0
    if not intensity_ch:
        if sfc < 400:
            slen = ((sfc >> 4) // 5, (sfc >> 4) % 5, (sfc % 16) >> 2, sfc % 4)
            bn = 0
        elif sfc < 500:
            s = sfc - 400
            slen = ((s >> 2) // 5, (s >> 2) % 5, s % 4, 0)
            bn = 1
        else:
            s = sfc - 500
            slen = (s // 3, s % 3, 0, 0)
            bn = 2
            g.preflag = 1
    else:
        s = sfc >> 1
        if s < 180:
            slen = (s // 36, (s % 36) // 6, s % 6, 0)
            bn = 3
        elif s < 244:
            s -= 180
            slen = ((s % 64) >> 4, (s % 16) >> 2, s % 4, 0)
            bn = 4
        else:
            s -= 244
            slen = (s // 3, s % 3, 0, 0)
            bn = 5
    short = g.window_switching and g.block_type == 2
    cls = 0 if not short else (2 if g.mixed_block else 1)
    counts = NR_OF_SFB[bn][cls]
    vals = []
    for part in range(4):
        nbits = slen[part]
        for _ in range(counts[part]):
            vals.append(br.get(nbits) if nbits else 0)
    if short and not g.mixed_block:
        sf = np.zeros((13, 3), np.int32)
        for i, v in enumerate(vals):
            sf[i // 3, i % 3] = v
        g.scalefac_s = sf
        g.scalefac_l = np.zeros(22, np.int32)
    elif short:  # mixed: first 6 long bands, then short sfb 3..11
        sl = np.zeros(22, np.int32)
        sl[:6] = vals[:6]
        sf = np.zeros((13, 3), np.int32)
        for i, v in enumerate(vals[6:]):
            sf[3 + i // 3, i % 3] = v
        g.scalefac_l = sl
        g.scalefac_s = sf
    else:
        sl = np.zeros(22, np.int32)
        sl[:len(vals)] = vals
        g.scalefac_l = sl
        g.scalefac_s = np.zeros((13, 3), np.int32)


# ---------------------------------------------------------------------------
# huffman region decode
# ---------------------------------------------------------------------------

def _huffman(br: _Bits, g: _Granule, rate: int, bits_end: int) -> np.ndarray:
    x = np.zeros(576, np.float64)
    long_b, _short_b = SFB[rate]
    if g.window_switching:
        # implied split for window-switching granules, in scalefactor-band
        # units (verified against libmpg123 across all 9 rates: short
        # blocks use 3*short_b[3], start/stop/mixed use long_b[8] — NOT
        # the flat 36/54 some implementations hard-code)
        if g.block_type == 2 and not g.mixed_block:
            region1 = 3 * SFB[rate][1][3]
        else:
            region1 = long_b[8]
        region2 = 576
    else:
        region1 = long_b[min(g.region0_count + 1, 22)]
        region2 = long_b[min(g.region0_count + g.region1_count + 2, 22)]
    nbig = min(2 * g.big_values, 576)
    line = 0
    get = br.get
    while line < nbig:
        if line < region1:
            tab = g.table_select[0]
        elif line < region2:
            tab = g.table_select[1]
        else:
            tab = g.table_select[2]
        key = CODE_OF[tab]
        if key is None:
            x[line:line + 2] = 0.0
            line += 2
            continue
        lut, maxlen = _big_lut(key)
        linbits = LINBITS[tab]
        packed = int(lut[br.peek(maxlen)])
        hlen = packed & 0xFF
        if hlen == 0:  # invalid bitstream; bail to zeros
            break
        br.pos += hlen
        vx = (packed >> 12) & 0xF
        vy = (packed >> 8) & 0xF
        if vx == 15 and linbits:
            vx += get(linbits)
        fx = _POW43[vx] if vx < 8207 else float(vx) ** (4.0 / 3.0)
        if vx and get(1):
            fx = -fx
        if vy == 15 and linbits:
            vy += get(linbits)
        fy = _POW43[vy] if vy < 8207 else float(vy) ** (4.0 / 3.0)
        if vy and get(1):
            fy = -fy
        x[line] = fx
        x[line + 1] = fy
        line += 2
        if br.pos > bits_end:
            break
    # count1 region: quads until the granule's bit budget is exhausted
    lut, maxlen = _count1_lut(bool(g.count1table_select))
    while line + 4 <= 576 and br.pos < bits_end:
        packed = int(lut[br.peek(maxlen)])
        hlen = packed & 0xFF
        if hlen == 0:
            break
        br.pos += hlen
        quad = (packed >> 8) & 0xF
        vals = ((quad >> 3) & 1, (quad >> 2) & 1, (quad >> 1) & 1, quad & 1)
        for i, v in enumerate(vals):
            if v and get(1):
                x[line + i] = -1.0
            elif v:
                x[line + i] = 1.0
        line += 4
    if br.pos > bits_end:
        # overrun: the last quad was phantom — zero it (standard practice)
        x[max(0, line - 4):line] = 0.0
    return x


# ---------------------------------------------------------------------------
# requantize / reorder / stereo / alias / imdct / synthesis
# ---------------------------------------------------------------------------

def _requantize(x: np.ndarray, g: _Granule, rate: int) -> np.ndarray:
    long_b, short_b = SFB[rate]
    mult = 1.0 if g.scalefac_scale else 0.5
    gain = 0.25 * (g.global_gain - 210)
    short = g.window_switching and g.block_type == 2
    exp = np.zeros(576)
    if not short or g.mixed_block:
        nlong = 576 if not short else 36
        sfac = g.scalefac_l + (PRETAB * g.preflag if g.preflag else 0)
        for sfb in range(22):
            a, b = long_b[sfb], long_b[sfb + 1]
            if a >= nlong:
                break
            exp[a:min(b, nlong)] = gain - mult * float(sfac[sfb])
    if short:
        first_short_sfb = 3 if g.mixed_block else 0
        for sfb in range(first_short_sfb, 13):
            a, b = short_b[sfb], short_b[sfb + 1]
            w = b - a
            for win in range(3):
                e = (gain - 2.0 * g.subblock_gain[win]
                     - mult * float(g.scalefac_s[sfb, win]
                                    if sfb < 13 else 0))
                # huffman order: [sfb][win][i] contiguous
                s = 3 * a + win * w
                exp[s:s + w] = e
    out = x * np.exp2(exp)
    return out


def _reorder_short(x: np.ndarray, g: _Granule, rate: int) -> np.ndarray:
    if not (g.window_switching and g.block_type == 2):
        return x
    _long_b, short_b = SFB[rate]
    out = x.copy()
    first = 3 if g.mixed_block else 0
    for sfb in range(first, 13):
        a, b = short_b[sfb], short_b[sfb + 1]
        w = b - a
        base = 3 * a
        seg = x[base:base + 3 * w].reshape(3, w)
        out[base:base + 3 * w] = seg.T.reshape(-1)
    return out


def _alias_reduce(x: np.ndarray, g: _Granule) -> None:
    if g.window_switching and g.block_type == 2 and not g.mixed_block:
        return
    nb = 2 if (g.window_switching and g.block_type == 2) else 32
    for sb in range(1, nb):
        b = 18 * sb
        lo = x[b - 1:b - 9:-1].copy()   # x[b-1], x[b-2], ..., x[b-8]
        hi = x[b:b + 8].copy()
        x[b - 1:b - 9:-1] = lo * _CS - hi * _CA
        x[b:b + 8] = hi * _CS + lo * _CA


def _imdct_granule(x: np.ndarray, g: _Granule, overlap: np.ndarray
                   ) -> np.ndarray:
    """x: 576 lines -> 576 time samples; overlap: [32, 18] state."""
    out = np.empty((32, 18))
    short = g.window_switching and g.block_type == 2
    X = x.reshape(32, 18)
    for sb in range(32):
        long_here = (not short) or (g.mixed_block and sb < 2)
        if long_here:
            bt = g.block_type if not (g.mixed_block and sb < 2) else 0
            z = (_IMDCT36 @ X[sb]) * _WIN[bt]
        else:
            z = np.zeros(36)
            for w in range(3):
                zw = (_IMDCT12 @ X[sb, w::3]) * _WIN12
                z[6 + 6 * w:18 + 6 * w] += zw
        out[sb] = z[:18] + overlap[sb]
        overlap[sb] = z[18:]
    # frequency inversion: odd subbands, odd time samples
    out[1::2, 1::2] *= -1.0
    return out


class _Synth:
    """Polyphase synthesis filterbank (spec Figure A.2)."""

    def __init__(self):
        self.v = np.zeros(1024)

    def run(self, sb_samples: np.ndarray) -> np.ndarray:
        """sb_samples: [32, 18] -> 576 PCM samples."""
        v = self.v
        pcm = np.empty((18, 32))
        for t in range(18):
            v = np.roll(v, 64)
            v[:64] = _NMAT @ sb_samples[:, t]
            u = np.empty(512)
            for i in range(8):
                u[64 * i:64 * i + 32] = v[128 * i:128 * i + 32]
                u[64 * i + 32:64 * i + 64] = v[128 * i + 96:128 * i + 128]
            w = u * _DWIN
            pcm[t] = w.reshape(16, 32).sum(axis=0)
        self.v = v
        return pcm.reshape(-1)


# ---------------------------------------------------------------------------
# top-level decode
# ---------------------------------------------------------------------------

def decode_mp3(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an mp3 stream -> (float32 mono PCM in [-1, 1], sample_rate)."""
    reservoir = bytearray()
    chunks: list[np.ndarray] = []
    rate_out = None
    overlap = None
    synth = None
    for i, fr in enumerate(_parse_frames(data)):
        if i == 0 and fr.tag:
            continue  # the VBR header frame is metadata, not audio
        v1 = fr.version == 3
        nch = fr.nch
        if rate_out is None:
            rate_out = fr.rate
            overlap = [np.zeros((32, 18)) for _ in range(2)]
            synth = [_Synth() for _ in range(2)]
        elif fr.rate != rate_out:
            break  # rate change mid-stream: stop at the consistent prefix
        start_byte = len(reservoir) - fr.main_data_begin
        reservoir.extend(fr.main)
        if start_byte < 0:
            continue  # reservoir not yet primed (stream start)
        br = _Bits(reservoir, start_byte * 8)
        granule_pcm = []
        for gr, chs in enumerate(fr.granules):
            xs = []
            for ch, g in enumerate(chs):
                bits_end = br.pos + g.part2_3_length
                if g.part2_3_length == 0:
                    g.scalefac_l = np.zeros(22, np.int32)
                    g.scalefac_s = np.zeros((13, 3), np.int32)
                    xs.append(np.zeros(576))
                    continue
                if v1:
                    prev = fr.granules[0][ch] if gr == 1 else None
                    _read_scalefacs_v1(br, g, gr, fr.scfsi[ch], prev)
                else:
                    ist = (fr.mode == 1 and (fr.mode_ext & 1) and ch == 1)
                    _read_scalefacs_lsf(br, g, ist)
                if br.pos > bits_end:
                    xs.append(np.zeros(576))
                    continue
                x = _huffman(br, g, fr.rate, bits_end)
                br.pos = bits_end
                xs.append(_requantize(x, g, fr.rate))
            if nch == 2:
                _stereo(xs, fr, chs)
            pcm_ch = []
            for ch, g in enumerate(chs):
                x = _reorder_short(xs[ch], g, fr.rate)
                _alias_reduce(x, g)
                sb = _imdct_granule(x, g, overlap[ch])
                pcm_ch.append(synth[ch].run(sb))
            granule_pcm.append(np.mean(pcm_ch, axis=0) if nch == 2
                               else pcm_ch[0])
        if len(reservoir) > 4096:
            drop = len(reservoir) - 2048
            del reservoir[:drop]
        chunks.append(np.concatenate(granule_pcm))
    if not chunks or rate_out is None:
        raise ValueError("no decodable mp3 frames found")
    pcm = np.concatenate(chunks)
    return np.clip(pcm, -1.0, 1.0).astype(np.float32), rate_out


def _stereo(xs: list, fr: _Frame, chs: list) -> None:
    """Apply MS / intensity processing in place (joint stereo)."""
    ms = fr.mode == 1 and (fr.mode_ext & 2)
    intensity = fr.mode == 1 and (fr.mode_ext & 1)
    L, R = xs
    if intensity:
        _apply_intensity(L, R, fr, chs, bool(ms))
    if ms:
        inv = 1.0 / math.sqrt(2.0)
        m = (L + R) * inv
        s = (L - R) * inv
        if intensity:
            # MS applies only below the intensity region
            bound = _intensity_bound(R, fr, chs[1])
            L[:bound], R[:bound] = m[:bound], s[:bound]
        else:
            L[:], R[:] = m, s


def _intensity_bound(right: np.ndarray, fr: _Frame, g: _Granule) -> int:
    """First line of the intensity region: start of the right channel's
    trailing all-zero scalefactor bands."""
    long_b, short_b = SFB[fr.rate]
    short = g.window_switching and g.block_type == 2
    bands = short_b if short else long_b
    scale = 3 if short else 1
    bound = bands[-1] * scale
    for sfb in range(len(bands) - 2, -1, -1):
        a, b = bands[sfb] * scale, bands[sfb + 1] * scale
        if np.any(right[a:b] != 0.0):
            break
        bound = a
    return bound


def _apply_intensity(L: np.ndarray, R: np.ndarray, fr: _Frame,
                     chs: list, ms: bool) -> None:
    g = chs[1]
    long_b, short_b = SFB[fr.rate]
    bound = _intensity_bound(R, fr, g)
    short = g.window_switching and g.block_type == 2
    v1 = fr.version == 3
    lsf_io = 2.0 ** (-0.25 * ((g.scalefac_compress & 1) + 1))
    bands = short_b if short else long_b
    scale = 3 if short else 1
    nb = 12 if short else 21
    for sfb in range(nb + 1):
        if sfb >= len(bands) - 1:
            break
        a, b = bands[sfb] * scale, bands[sfb + 1] * scale
        if a < bound:
            continue
        for win in range(3 if short else 1):
            if short:
                w = bands[sfb + 1] - bands[sfb]
                s0 = bands[sfb] * 3 + win * w
                sl = slice(s0, s0 + w)
                is_pos = int(g.scalefac_s[sfb, win])
            else:
                sl = slice(a, b)
                is_pos = int(g.scalefac_l[sfb])
            if v1:
                if is_pos == 7:
                    if ms:
                        inv = 1.0 / math.sqrt(2.0)
                        m, s = L[sl].copy(), R[sl].copy()
                        L[sl] = (m + s) * inv
                        R[sl] = (m - s) * inv
                    continue
                ratio = math.tan(is_pos * math.pi / 12.0)
                k0 = ratio / (1.0 + ratio)
                k1 = 1.0 / (1.0 + ratio)
            else:
                if is_pos == 0:
                    k0 = k1 = 1.0
                elif is_pos & 1:
                    k0 = lsf_io ** ((is_pos + 1) >> 1)
                    k1 = 1.0
                else:
                    k0 = 1.0
                    k1 = lsf_io ** (is_pos >> 1)
            v = L[sl].copy()
            L[sl] = v * k0
            R[sl] = v * k1
