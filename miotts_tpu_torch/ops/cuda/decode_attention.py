"""Kernel K2: one-token GQA attention over the KV cache (the LLM decode step).

Wraps ``csrc/decode_attention.cu`` (replaces the Pallas kernel
miotts_tpu/ops/pallas/decode_attention.py::decode_attention_pallas). The
plain version mirrors ``decode_attention_xla`` of the same file. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel, or
raises on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

SOURCE = "miotts_tpu_torch/csrc/decode_attention.cu"
REPLACES = "miotts_tpu/ops/pallas/decode_attention.py:168"

# launches of the CUDA kernel in this process (the plain version and
# refusals do not count); callers may reset it to 0
launches = 0

SPLIT = 8  # blocks of a thread-block cluster, each one range of cache rows (kSplit)
_MAX_G = 8  # query heads a kv head (csrc/decode_attention.cu kMaxG)

_fn = None


def launch_shape(B: int, S: int, KVH: int) -> tuple[int, int, int]:
    """(grid x, grid y, rows a block) of the kernel for B lanes, an S-row
    cache and KVH kv heads: one cluster of SPLIT blocks per (lane, kv head),
    block ``rank`` taking rows [rank * R, (rank + 1) * R) clipped to
    [0, pos). It depends on S, B and KVH only, never on pos."""
    return SPLIT, B * KVH, max(1, math.ceil(S / SPLIT))


def _entry():
    global _fn
    if _fn is None:
        fn = build.load_library().miotts_decode_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def decode_attention_plain(q, k_cur, v_cur, cache_k, cache_v, scale: float, pos) -> torch.Tensor:
    """Plain PyTorch version, same operand contract as the kernel.

    q: [B, KVH, G, HD]; k_cur/v_cur: [B, KVH, HD] (cache dtype);
    cache_k/cache_v: [B, S, KVH, HD]; pos: [B] int32. Keys strictly below
    pos plus the current token. Returns [B, KVH*G*HD] in the cache dtype:
    f32 scores and softmax, probabilities rounded to the cache dtype before
    the value product (decode_attention_xla)."""
    B, S = cache_k.shape[:2]
    kmask = torch.arange(S, device=pos.device)[None, :] < pos[:, None]  # [B, S]
    m4 = kmask[:, None, None, :]
    scores = torch.einsum("bngd,bsnd->bngs", q.float(), cache_k.float()) * scale
    scores = scores.masked_fill(~m4, float("-inf"))
    s_cur = torch.einsum("bngd,bnd->bng", q.float(), k_cur.float())[..., None] * scale
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), s_cur)
    e = torch.where(m4, torch.exp(scores - m), torch.zeros((), device=q.device))
    e_cur = torch.exp(s_cur - m)
    denom = e.sum(dim=-1, keepdim=True) + e_cur
    probs = (e / denom).to(cache_v.dtype)
    att = torch.einsum("bngs,bsnd->bngd", probs.float(), cache_v.float()).to(cache_v.dtype)
    att = att + (e_cur / denom).to(att.dtype) * v_cur[:, :, None, :].to(att.dtype)
    return att.reshape(B, -1)


def decode_attention(q, k_cur, v_cur, cache_k, cache_v, scale: float, pos) -> torch.Tensor:
    """Dispatch by device: plain version on the CPU, the kernel on CUDA
    (bf16 operands, bf16 output [B, KVH*G*HD])."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cur, v_cur, cache_k, cache_v, scale, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention: unsupported device {q.device}")
    B, S, KVH, HD = cache_k.shape
    G = q.shape[2]
    want = {"q": (B, KVH, G, HD), "k_cur": (B, KVH, HD), "v_cur": (B, KVH, HD),
            "cache_k": (B, S, KVH, HD), "cache_v": (B, S, KVH, HD)}
    got = {"q": q, "k_cur": k_cur, "v_cur": v_cur, "cache_k": cache_k, "cache_v": cache_v}
    for name, x in got.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(f"decode attention: {name} shape {tuple(x.shape)}, expected {want[name]}")
        if (x.dtype != torch.bfloat16 or x.device != q.device or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"decode attention: {name} must be contiguous, 16-byte aligned "
                             f"bf16 on {q.device}")
    if (pos.dtype != torch.int32 or pos.device != q.device or tuple(pos.shape) != (B,)
            or not pos.is_contiguous()):
        raise ValueError(f"decode attention: pos must be contiguous int32 [{B}] on {q.device}")
    _, lanes, rows = launch_shape(B, S, KVH)
    if not 1 <= G <= _MAX_G or HD not in (32, 64, 128) or not 1 <= lanes <= 65535:
        raise ValueError(f"decode attention: unsupported G={G}, HD={HD}, B*KVH={lanes}")
    out = torch.empty((B, KVH * G * HD), dtype=torch.bfloat16, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _entry()(q.data_ptr(), k_cur.data_ptr(), v_cur.data_ptr(), cache_k.data_ptr(),
                      cache_v.data_ptr(), pos.data_ptr(), out.data_ptr(),
                      B, S, KVH, G, HD, rows, float(scale), stream)
    build.check(status, "decode_attention")
    launches += 1
    return out
