"""Mono mp3 streams from libmp3lame with the two settings that
tests/mp3_oracles.lame_encode leaves off: CRC-protected frames
(``lame_set_error_protection``) and LAME's Info tag frame in front
(``bWriteVbrTag``; the frame from ``lame_get_lametag_frame`` after the
flush, written where LAME's placeholder stands). Dev-time only, as
mp3_oracles: tests and scripts/gen_torch_mp3_fixtures.py use it where
``mp3_oracles.have_oracles()``."""
from __future__ import annotations

import ctypes

import numpy as np

from mp3_oracles import _LAME


def lame_stream(pcm: np.ndarray, rate: int, bitrate: int, *, crc: bool = False,
                info_tag: bool = False) -> bytes:
    """``pcm`` (f32 mono in [-1, 1]) encoded as ``lame_encode`` encodes it
    (quality 2, CBR ``bitrate``), with CRC frames and/or LAME's Info frame."""
    lame = ctypes.CDLL(_LAME)
    vp = ctypes.c_void_p
    lame.lame_init.restype = vp
    gf = lame.lame_init()
    for name, val in (("in_samplerate", rate), ("out_samplerate", rate), ("num_channels", 1),
                      ("brate", bitrate), ("mode", 3), ("bWriteVbrTag", int(info_tag)),
                      ("quality", 2), ("error_protection", int(crc))):
        f = getattr(lame, f"lame_set_{name}")
        f.argtypes = [vp, ctypes.c_int]
        f(gf, val)
    lame.lame_init_params.argtypes = [vp]
    if lame.lame_init_params(gf) != 0:
        raise RuntimeError("lame_init_params failed")
    x = (np.clip(pcm, -1.0, 1.0) * 32767).astype(np.int16)
    buf = ctypes.create_string_buffer(int(1.25 * x.size) + 7200)
    lame.lame_encode_buffer.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    w = lame.lame_encode_buffer(gf, x.ctypes.data, x.ctypes.data, x.size, buf, len(buf))
    lame.lame_encode_flush.argtypes = [vp, vp, ctypes.c_int]
    w += lame.lame_encode_flush(gf, ctypes.addressof(buf) + w, len(buf) - w)
    stream = buf.raw[:w]
    if info_tag:
        lame.lame_get_lametag_frame.argtypes = [vp, ctypes.c_char_p, ctypes.c_size_t]
        lame.lame_get_lametag_frame.restype = ctypes.c_size_t
        tag = ctypes.create_string_buffer(4096)
        n = lame.lame_get_lametag_frame(gf, tag, len(tag))
        if not n or b"Info" not in tag.raw[:n]:
            raise RuntimeError("LAME wrote no Info tag frame")
        stream = tag.raw[:n] + stream[n:]
    lame.lame_close.argtypes = [vp]
    lame.lame_close(gf)
    return stream
