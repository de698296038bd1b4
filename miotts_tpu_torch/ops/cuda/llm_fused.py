"""Kernels K7-K10: the LLM decode step's per-layer glue, fused, and the
served step's sampler.

Wraps ``csrc/llm_fused.cu``. These kernels replace no Pallas kernel: on
the TPU, XLA fused the norms, RoPE, the bias and residual adds and silu
into the matmuls around them, where PyTorch runs each expression as its
own kernel (~54 a layer inside a chunk graph). Each is bound by its few KB
of bytes and, far more, by its launch and the gap after it; the design's
aim is fewer launches, so a layer runs K7 -> QKV GEMM -> K8 -> K2 -> wo
GEMM -> K7 -> gate|up GEMM -> K9 -> down GEMM.

- K7 ``add_rms_norm``: the residual add (in place) and the RMSNorm after it.
- K8 ``qkv_rope_cache``: the QKV bias, RoPE on q and k, q in K2's layout,
  this step's k/v, and their row of the layer's KV cache at pos.
- K9 ``silu_mul``: silu(gate) * up over the gate|up product.

K10 ``sample_step`` (``csrc/llm_sample.cu``) runs the served chunk body's
sampler and bookkeeping once a step, for every lane: the repeat penalty,
the 256-candidate pool, top-p, the draw, the key, the ring, the output
token, the count and done flags, and each lane's pos advance.

Each has a plain PyTorch version that repeats the expressions it replaces
(``models/llm.py``'s decode step before the fusion, ``ops/rope.py``,
``models/sampling.py``'s ``sample_step_plain``), dtype promotions
included: a CPU tensor takes it; a CUDA tensor launches the kernel, or
raises on anything the kernel does not take. Each kernel counts its
launches (``KERNELS``; K10 one a call of its two launches), through
``graphs.launched``, so a chunk graph's replays count.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...models import sampling
from . import build, graphs

SOURCE = "miotts_tpu_torch/csrc/llm_fused.cu"
SAMPLE_SOURCE = "miotts_tpu_torch/csrc/llm_sample.cu"
REPLACES = None  # no Pallas kernel: XLA fused this glue, and the sampler, on the TPU


class Kernel:
    """One fused kernel's launch counter: ``launches`` of the CUDA kernel in
    this process, graph replays included (the plain version and refusals do
    not count); callers may reset it to 0. ``__name__`` is the key under
    which ``graphs.launched`` counts it."""

    def __init__(self, name: str):
        self.name = name
        self.__name__ = f"{__name__}.{name}"
        self.launches = 0


ADD_RMS_NORM = Kernel("add_rms_norm")  # K7
QKV_ROPE_CACHE = Kernel("qkv_rope_cache")  # K8
SILU_MUL = Kernel("silu_mul")  # K9
SAMPLE_STEP = Kernel("sample_step")  # K10
KERNELS = (ADD_RMS_NORM, QKV_ROPE_CACHE, SILU_MUL, SAMPLE_STEP)

_fns: dict = {}
# RoPE inverse frequencies by (device, head_dim, base): computed once
_inv_freq: dict = {}


def _entry(name: str, argtypes: list):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load_library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _refuse(what: str, msg: str):
    raise ValueError(f"{what}: {msg}")


def _check_bf16(what: str, name: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.dtype != torch.bfloat16 or t.device != dev or t.data_ptr() % 16:
        _refuse(what, f"{name} must be 16-byte aligned bf16 on {dev}")


def rope_inv_freq(head_dim: int, base: float, device: torch.device) -> torch.Tensor:
    """theta^(-2i/d) [head_dim // 2] f32 on ``device``, by ``rope_angles``'
    own expression (``ops/rope.py``), computed once a (device, head_dim,
    base). During a graph capture a missing entry is computed but not kept:
    it would be a graph-pool tensor that nothing outside the graph wrote."""
    key = (torch.device(device), head_dim, float(base))
    t = _inv_freq.get(key)
    if t is None:
        exponents = torch.arange(head_dim // 2, dtype=torch.float32,
                                 device=device) * (-2.0 / head_dim)
        t = torch.pow(base, exponents)
        if not graphs.capturing():
            _inv_freq[key] = t
    return t


# ---------------------------------------------------------------------------
# K7: residual add + RMSNorm
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with f32 statistics and the f32 weight, in x's dtype."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * weight).to(x.dtype)


def add_rms_norm_plain(x: torch.Tensor, delta: torch.Tensor | None, weight: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """``x = x + delta`` (in place; none without ``delta``), then
    ``rms_norm(x, weight, eps)``."""
    if delta is not None:
        x.copy_(x + delta)
    return rms_norm(x, weight, eps)


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor | None, weight: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """x [..., D] += delta [..., D] IN PLACE (the residual add; skipped when
    ``delta`` is None), then the RMSNorm of x by ``weight`` [D] f32: a new
    tensor of x's shape and dtype. On CUDA one launch of K7 (bf16 x and
    delta, x contiguous, delta's rows at any stride a multiple of 8)."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, delta, weight, eps)
    what = "add_rms_norm"
    if x.device.type != "cuda":
        _refuse(what, f"unsupported device {x.device}")
    D = x.shape[-1]
    rows = x.numel() // max(D, 1)
    _check_bf16(what, "x", x, x.device)
    if not x.is_contiguous():
        _refuse(what, "x must be contiguous")
    if (weight.dtype != torch.float32 or weight.device != x.device
            or tuple(weight.shape) != (D,) or not weight.is_contiguous() or weight.data_ptr() % 16):
        _refuse(what, f"weight must be contiguous, 16-byte aligned f32 [{D}] on {x.device}")
    ld = 0
    if delta is not None:
        _check_bf16(what, "delta", delta, x.device)
        if tuple(delta.shape) != tuple(x.shape) or delta.stride(-1) != 1:
            _refuse(what, f"delta {tuple(delta.shape)} for x {tuple(x.shape)}, or its last "
                          "dim strided")
        d2 = delta.reshape(rows, D)  # a view: rows of one stride
        ld = d2.stride(0)
    if D % 8 or D // 8 > 1024 or not 1 <= rows <= 65535 or ld % 8:
        _refuse(what, f"unsupported D={D}, rows={rows}, delta row stride {ld}")
    out = torch.empty_like(x)
    fn = _entry("miotts_add_rms_norm_bf16",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    status = build.launch(x.device, fn, x.data_ptr(), None if delta is None else delta.data_ptr(),
                          ld, weight.data_ptr(), out.data_ptr(), rows, D, float(eps), _stream(x))
    build.check(status, what)
    graphs.launched(ADD_RMS_NORM.__name__)
    return out


# ---------------------------------------------------------------------------
# K8: QKV bias + RoPE + this step's KV-cache row
# ---------------------------------------------------------------------------

def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, neox: bool) -> torch.Tensor:
    """``apply_rope``'s rotation of x [B, T, H, D] by tables [B, T, 1, D/2]."""
    B, T, H, D = x.shape
    xf = x.float()
    if neox:
        x0, x1 = xf[..., : D // 2], xf[..., D // 2:]
        y = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    else:
        xp = xf.reshape(B, T, H, D // 2, 2)
        y0 = xp[..., 0] * cos - xp[..., 1] * sin
        y1 = xp[..., 0] * sin + xp[..., 1] * cos
        y = torch.stack([y0, y1], dim=-1).reshape(B, T, H, D)
    return y.to(x.dtype)


def write_kv_row(cache_k: torch.Tensor, cache_v: torch.Tensor, k1: torch.Tensor,
                 v1: torch.Tensor, pos: torch.Tensor) -> None:
    """Lane b's k1[b]/v1[b] [KVH, HD] into row pos[b] of its cache [B, S,
    KVH, HD], IN PLACE; a pos at or past S writes nothing."""
    B, S = cache_k.shape[:2]
    b_idx = torch.arange(B, device=pos.device)
    in_range = (pos < S)[:, None, None]
    p = torch.clamp(pos.long(), max=S - 1)
    for cache, new in ((cache_k, k1), (cache_v, v1)):
        cache[b_idx, p] = torch.where(in_range, new.to(cache.dtype), cache[b_idx, p])


def qkv_rope_cache_plain(qkv, bias, inv_freq, pos, cache_k, cache_v, n_heads: int, neox: bool):
    """Plain version of ``qkv_rope_cache``: the expressions of the decode
    step before the fusion (``_layer_qkv``, ``apply_rope`` on q and k, the
    cache-dtype k/v, q in K2's layout), then the row write."""
    B = qkv.shape[0]
    S, KVH, HD = cache_k.shape[1:]
    Hd, KVd = n_heads * HD, KVH * HD
    qkv = qkv.reshape(B, 1, -1)[..., :Hd + 2 * KVd]
    if bias is not None:
        qkv = qkv + bias
    q = qkv[..., :Hd].reshape(B, 1, n_heads, HD)
    k = qkv[..., Hd:Hd + KVd].reshape(B, 1, KVH, HD)
    v = qkv[..., Hd + KVd:].reshape(B, 1, KVH, HD)
    ang = pos[:, None].float()[..., None] * inv_freq
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    q, k = _rotate(q, cos, sin, neox), _rotate(k, cos, sin, neox)
    k1 = k[:, 0].to(cache_k.dtype).contiguous()
    v1 = v[:, 0].to(cache_v.dtype).contiguous()
    qh = q[:, 0].reshape(B, KVH, n_heads // KVH, HD).contiguous()
    write_kv_row(cache_k, cache_v, k1, v1, pos)
    return qh, k1, v1


def qkv_rope_cache(qkv: torch.Tensor, bias: torch.Tensor | None, inv_freq: torch.Tensor,
                   pos: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                   n_heads: int, neox: bool):
    """One decode step's q, k and v from the fused QKV product ``qkv`` [B,
    (1,) N] (N >= (H + 2 KVH) HD: a quantized leaf pads it; columns q | k |
    v), with ``bias`` [(H + 2 KVH) HD] or None, rotated at ``pos`` [B] int32
    by ``inv_freq`` [HD / 2] (``rope_inv_freq``), NEOX or adjacent pairs.
    Returns (qh [B, KVH, G, HD], k1 [B, KVH, HD], v1 [B, KVH, HD]), K2's
    operands, and writes k1/v1 into row pos of ``cache_k``/``cache_v`` [B,
    S, KVH, HD] IN PLACE (nothing where pos >= S); K2 reads the cache below
    pos only. On CUDA one launch of K8 (bf16, caches contiguous)."""
    if qkv.device.type == "cpu":
        return qkv_rope_cache_plain(qkv, bias, inv_freq, pos, cache_k, cache_v, n_heads, neox)
    what = "qkv_rope_cache"
    dev = qkv.device
    if dev.type != "cuda":
        _refuse(what, f"unsupported device {dev}")
    B, S, KVH, HD = cache_k.shape
    H = n_heads
    x2 = qkv.reshape(B, -1)
    if x2.stride(-1) != 1 or x2.shape[1] < (H + 2 * KVH) * HD:
        _refuse(what, f"qkv {tuple(qkv.shape)}: too narrow for {H}+2x{KVH} heads of {HD}, "
                      "or its last dim strided")
    for name, t in (("qkv", x2), ("cache_k", cache_k), ("cache_v", cache_v)):
        _check_bf16(what, name, t, dev)
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        if not t.is_contiguous() or tuple(t.shape) != (B, S, KVH, HD):
            _refuse(what, f"{name} must be contiguous [{B}, {S}, {KVH}, {HD}]")
    if bias is not None:
        _check_bf16(what, "bias", bias, dev)
        if tuple(bias.shape) != ((H + 2 * KVH) * HD,) or not bias.is_contiguous():
            _refuse(what, f"bias {tuple(bias.shape)}, expected [{(H + 2 * KVH) * HD}]")
    if (inv_freq.dtype != torch.float32 or inv_freq.device != dev
            or tuple(inv_freq.shape) != (HD // 2,) or not inv_freq.is_contiguous()):
        _refuse(what, f"inv_freq must be contiguous f32 [{HD // 2}] on {dev}")
    if pos.dtype != torch.int32 or pos.device != dev or tuple(pos.shape) != (B,) \
            or not pos.is_contiguous():
        _refuse(what, f"pos must be contiguous int32 [{B}] on {dev}")
    if HD % 2 or H % KVH or not 1 <= B <= 65535:
        _refuse(what, f"unsupported HD={HD}, H={H}, KVH={KVH}, B={B}")
    qh = torch.empty((B, KVH, H // KVH, HD), dtype=torch.bfloat16, device=dev)
    k1 = torch.empty((B, KVH, HD), dtype=torch.bfloat16, device=dev)
    v1 = torch.empty_like(k1)
    fn = _entry("miotts_qkv_rope_cache_bf16",
                [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 8
                + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    status = build.launch(dev, fn, x2.data_ptr(), x2.stride(0),
                          None if bias is None else bias.data_ptr(), inv_freq.data_ptr(),
                          pos.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), qh.data_ptr(),
                          k1.data_ptr(), v1.data_ptr(), B, H, KVH, HD, S, int(bool(neox)),
                          _stream(qkv))
    build.check(status, what)
    graphs.launched(QKV_ROPE_CACHE.__name__)
    return qh, k1, v1


# ---------------------------------------------------------------------------
# K9: silu(gate) * up
# ---------------------------------------------------------------------------

def silu_mul_plain(gu: torch.Tensor, ffn_dim: int) -> torch.Tensor:
    gate, up = gu[..., :ffn_dim], gu[..., ffn_dim:2 * ffn_dim]
    return F.silu(gate) * up


def silu_mul(gu: torch.Tensor, ffn_dim: int) -> torch.Tensor:
    """``F.silu(gate) * up`` with gate = gu[..., :F] and up = gu[..., F:2F]
    of the fused gate|up product (a quantized leaf may pad it past 2F): [...,
    F] in gu's dtype. On CUDA one launch of K9 (bf16, rows contiguous)."""
    if gu.device.type == "cpu":
        return silu_mul_plain(gu, ffn_dim)
    what = "silu_mul"
    if gu.device.type != "cuda":
        _refuse(what, f"unsupported device {gu.device}")
    lead = gu.shape[:-1]
    rows = gu.numel() // max(gu.shape[-1], 1)
    g2 = gu.reshape(rows, gu.shape[-1])
    _check_bf16(what, "gu", g2, gu.device)
    if (g2.stride(-1) != 1 or g2.shape[1] < 2 * ffn_dim or ffn_dim % 8 or g2.stride(0) % 8
            or rows < 1):
        _refuse(what, f"gu {tuple(gu.shape)} for F={ffn_dim}: needs 2F columns, F and the row "
                      "stride multiples of 8, the last dim contiguous")
    out = torch.empty((*lead, ffn_dim), dtype=torch.bfloat16, device=gu.device)
    fn = _entry("miotts_silu_mul_bf16",
                [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p])
    status = build.launch(gu.device, fn, g2.data_ptr(), g2.stride(0), out.data_ptr(), rows,
                          ffn_dim, _stream(gu))
    build.check(status, what)
    graphs.launched(SILU_MUL.__name__)
    return out


# ---------------------------------------------------------------------------
# K10: one served decode step's sampler and bookkeeping
# ---------------------------------------------------------------------------

SAMPLE_MAX_LANES = 1024
_MAX_SLICES = 32  # select blocks a lane, of at most 12 288 values (csrc/llm_sample.cu)
SAMPLE_MAX_VOCAB = _MAX_SLICES * 512 * 24


def check_sample_step(logits: torch.Tensor, params: sampling.BatchSamplerParams,
                      state: sampling.SamplerState, key: torch.Tensor, eog_ids: torch.Tensor,
                      rem: torch.Tensor, done: torch.Tensor, count: torch.Tensor,
                      out: torch.Tensor) -> None:
    """Raise ValueError unless K10 takes these tensors (``sample_step``'s
    arguments): logits [B, V] f32 contiguous with 1 <= B <= 1024 and V <=
    393 216; the ring [B, 64] and key [B, 2] int64, the four knob tensors
    [B] (f32, top_k int32), rem and count [B] int32, done [B] bool, each
    contiguous; the cursor an int32 scalar; eog_ids 1-D int64 contiguous;
    out [B] int64 at any stride; all on logits' device."""
    what = "sample_step"
    dev = logits.device
    if logits.dim() != 2 or logits.dtype != torch.float32 or not logits.is_contiguous():
        _refuse(what, f"logits must be contiguous f32 [B, V], got {logits.dtype} "
                      f"{tuple(logits.shape)}")
    B, V = logits.shape
    if not 1 <= B <= SAMPLE_MAX_LANES or not 1 <= V <= SAMPLE_MAX_VOCAB:
        _refuse(what, f"B={B}, V={V}: K10 takes 1-{SAMPLE_MAX_LANES} lanes and a vocabulary of "
                      f"at most {SAMPLE_MAX_VOCAB}")
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    for name, t, dtype, shape in (
            ("ring", state.ring, i64, (B, sampling.PENALTY_LAST_N)), ("key", key, i64, (B, 2)),
            ("temp", params.temp, f32, (B,)), ("top_k", params.top_k, i32, (B,)),
            ("top_p", params.top_p, f32, (B,)), ("repeat_penalty", params.repeat_penalty, f32, (B,)),
            ("rem", rem, i32, (B,)), ("done", done, torch.bool, (B,)), ("count", count, i32, (B,)),
            ("ring_idx", state.idx, i32, ())):
        if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape or not t.is_contiguous():
            _refuse(what, f"{name} must be contiguous {dtype} {list(shape)} on {dev}, got "
                          f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (eog_ids.dtype != i64 or eog_ids.device != dev or eog_ids.dim() != 1
            or not eog_ids.is_contiguous()):
        _refuse(what, f"eog_ids must be contiguous 1-D int64 on {dev}")
    if out.dtype != i64 or out.device != dev or tuple(out.shape) != (B,):
        _refuse(what, f"out must be int64 [{B}] on {dev}")


def sample_step(logits: torch.Tensor, params: sampling.BatchSamplerParams,
                state: sampling.SamplerState, key: torch.Tensor, eog_ids: torch.Tensor,
                rem: torch.Tensor, done: torch.Tensor, count: torch.Tensor, out: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One served decode step's sampler and bookkeeping for every lane
    (``sampling.sample_step_plain``, whose meaning it has): returns (tok [B]
    int64, the step's sampled tokens; adv [B] int32, 1 where the lane goes
    on) and updates the ring and its cursor, ``key``'s draw counts,
    ``done``, ``count`` and ``out`` IN PLACE. On CUDA one call of K10 (two
    launches), checked by ``check_sample_step``. Greedy lanes, and sampled
    lanes with top-p off, pick the plain version's tokens bit for bit; a
    top-p mask may differ at a candidate whose cum - prob lies within f32
    rounding of top_p (the sums run in another order)."""
    if logits.device.type == "cpu":
        return sampling.sample_step_plain(logits, params, state, key, eog_ids, rem, done, count,
                                          out)
    what = "sample_step"
    dev = logits.device
    if dev.type != "cuda":
        _refuse(what, f"unsupported device {dev}")
    check_sample_step(logits, params, state, key, eog_ids, rem, done, count, out)
    B, V = logits.shape
    scratch = torch.empty((B * _MAX_SLICES * min(V, sampling.MAX_TOP_K) + 1,), dtype=torch.int64,
                          device=dev)
    tok = torch.empty((B,), dtype=torch.int64, device=dev)
    adv = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _entry("miotts_sample_step",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8
                + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                + [ctypes.c_void_p] * 4)
    status = build.launch(dev, fn, logits.data_ptr(), B, V, state.ring.data_ptr(),
                          params.repeat_penalty.data_ptr(), params.temp.data_ptr(),
                          params.top_k.data_ptr(), params.top_p.data_ptr(), key.data_ptr(),
                          state.idx.data_ptr(), eog_ids.data_ptr(), eog_ids.numel(),
                          rem.data_ptr(), done.data_ptr(), count.data_ptr(), out.data_ptr(),
                          out.stride(0), tok.data_ptr(), adv.data_ptr(), scratch.data_ptr(),
                          _stream(logits))
    build.check(status, what)
    graphs.launched(SAMPLE_STEP.__name__)
    return tok, adv
