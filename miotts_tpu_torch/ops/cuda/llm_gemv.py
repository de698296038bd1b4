"""Kernel family K11: the LLM decode step's bf16 GEMVs with the glue on
either side of each folded in.

Wraps ``csrc/llm_gemv.cu``. These kernels replace no Pallas kernel: on the
TPU, XLA fused the decode step's matmuls with their norms, bias, RoPE,
residual adds and silu. On one card a dense bf16 layer then runs as four
K11 launches around K2, and the step ends with ``norm_head``:

- ``norm_qkv``: RMSNorm, the fused q|k|v product, then K8's epilogue (the
  bias, RoPE, q in K2's layout, this step's k/v and their KV-cache row).
- ``gemv_residual``: a product added into the residual stream in place
  (attention-out, down), rounded where K7 rounds.
- ``norm_gateup``: RMSNorm, the gate|up product, then K9's silu(gate) * up.
- ``norm_head``: RMSNorm and the dense [V, D] head into f32 logits.

Each is bound by the bytes of its weight (1.2-6.3 MB a layer leaf, 233 MB
the 0.1B head); the source's header gives the design. Each has a plain
PyTorch version that repeats the unfused step's expressions (``rms_norm``,
``x @ w``, ``qkv_rope_cache_plain``, ``silu_mul_plain``, ``dense_logits``):
a CPU tensor takes it; a CUDA tensor launches the kernel, or raises on
anything the kernel does not take. Each kernel counts its launches
(``KERNELS``) through ``graphs.launched``, so a chunk graph's replays
count.

A layer kernel takes ``prod`` (a [B, N] bf16 tensor) to also write its
product rounded to bf16, so a check can hold the product to the library's
and the epilogue to its plain version on the same product; the decode step
passes none.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, graphs
from .llm_fused import Kernel, _check_bf16, _entry, _refuse, _stream, qkv_rope_cache_plain
from .llm_fused import rms_norm, silu_mul_plain

SOURCE = "miotts_tpu_torch/csrc/llm_gemv.cu"
REPLACES = None  # no Pallas kernel: XLA fused these matmuls with their glue on the TPU

NORM_QKV = Kernel("norm_qkv")
GEMV_RESIDUAL = Kernel("gemv_residual")
NORM_GATEUP = Kernel("norm_gateup")
NORM_HEAD = Kernel("norm_head")
KERNELS = (NORM_QKV, GEMV_RESIDUAL, NORM_GATEUP, NORM_HEAD)

MAX_ROWS = 8  # lanes a launch takes: the tensor cores' N
HEAD_DIM = 64  # norm_qkv's tile is one head
MAX_NORM_DIM = 1024  # the normed row's width
MAX_K = 2048  # a product's depth: 16 rows a k-step, 16 k-steps a CTA, 8 CTAs a cluster


def split_k(K: int, n_tiles: int) -> tuple[int, int]:
    """(CTAs a cluster, k-steps of 16 a CTA) for a [K, *] leaf cut into
    ``n_tiles`` output tiles: about 256 CTAs, at most 8 a cluster, at most
    16 k-steps a CTA (8 warps of 2)."""
    steps = K // 16
    split = max(-(-steps // 16), min(8, -(-256 // n_tiles)))
    return split, -(-steps // split)


def dense_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x [N, D] against a dense [V, D] head -> f32 [N, V], accumulated
    straight into f32. On CUDA one cuBLAS call writes f32 from bf16
    operands; the CPU build has no such matmul, so it multiplies the bf16
    values as f32, which gives the same exact products."""
    if x.dtype == torch.float32 and head.dtype == torch.float32:
        return x @ head.t()
    if x.device.type == "cuda":
        return torch.mm(x, head.t(), out_dtype=torch.float32)
    return x.float() @ head.float().t()


# ---------------------------------------------------------------------------
# plain versions: the unfused step's expressions
# ---------------------------------------------------------------------------

def norm_qkv_plain(x, norm_w, eps, w, bias, inv_freq, pos, cache_k, cache_v, n_heads: int,
                   neox: bool):
    return qkv_rope_cache_plain(rms_norm(x, norm_w, eps) @ w, bias, inv_freq, pos, cache_k,
                                cache_v, n_heads, neox)


def gemv_residual_plain(act: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> None:
    x.copy_(x + act @ w)


def norm_gateup_plain(x, norm_w, eps, w, ffn_dim: int) -> torch.Tensor:
    return silu_mul_plain(rms_norm(x, norm_w, eps) @ w, ffn_dim)


def norm_head_plain(x, norm_w, eps, head) -> torch.Tensor:
    xn = rms_norm(x, norm_w, eps)
    return dense_logits(xn.reshape(-1, xn.shape[-1]), head)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _rows(what: str, name: str, x: torch.Tensor, dev: torch.device) -> tuple[int, int]:
    """(rows, width) of a contiguous bf16 [..., width] operand of at most
    MAX_ROWS rows."""
    _check_bf16(what, name, x, dev)
    width = x.shape[-1]
    rows = x.numel() // max(width, 1)
    if not x.is_contiguous() or not 1 <= rows <= MAX_ROWS or width % 16:
        _refuse(what, f"{name} {tuple(x.shape)} must be contiguous, 1-{MAX_ROWS} rows of a "
                      "multiple of 16")
    return rows, width


def _check_norm(what: str, norm_w: torch.Tensor, D: int, dev: torch.device) -> None:
    if (norm_w.dtype != torch.float32 or norm_w.device != dev or tuple(norm_w.shape) != (D,)
            or not norm_w.is_contiguous() or norm_w.data_ptr() % 16 or D > MAX_NORM_DIM):
        _refuse(what, f"the norm weight must be contiguous, 16-byte aligned f32 [{D}] on {dev}, "
                      f"D <= {MAX_NORM_DIM}")


def _check_leaf(what: str, w: torch.Tensor, K: int, dev: torch.device) -> int:
    """The leaf's N; a [K, N] contiguous bf16 leaf, K <= MAX_K, N a multiple of 64."""
    _check_bf16(what, "w", w, dev)
    if w.dim() != 2 or w.shape[0] != K or not w.is_contiguous() or w.shape[1] % 64 or K > MAX_K:
        _refuse(what, f"w {tuple(w.shape)} must be a contiguous [{K}, N] leaf, N a multiple of 64, "
                      f"K <= {MAX_K}")
    return w.shape[1]


def _check_prod(what: str, prod, rows: int, N: int, dev: torch.device):
    if prod is None:
        return None
    _check_bf16(what, "prod", prod, dev)
    if prod.numel() != rows * N or not prod.is_contiguous():
        _refuse(what, f"prod must be a contiguous bf16 tensor of {rows} x {N}")
    return prod.data_ptr()


def norm_qkv(x: torch.Tensor, norm_w: torch.Tensor, eps: float, w: torch.Tensor,
             bias: torch.Tensor | None, inv_freq: torch.Tensor, pos: torch.Tensor,
             cache_k: torch.Tensor, cache_v: torch.Tensor, n_heads: int, neox: bool,
             prod: torch.Tensor | None = None):
    """``qkv_rope_cache`` of ``rms_norm(x, norm_w, eps) @ w``: x [B, (1,) D]
    the residual stream, w the fused q|k|v leaf [D, (H + 2 KVH) 64]. Returns
    (qh [B, KVH, G, 64], k1, v1 [B, KVH, 64]) and writes k1/v1 into row pos
    of the caches IN PLACE (none where pos >= S). On CUDA one launch of K11
    (bf16, B <= 8, head_dim 64)."""
    if x.device.type == "cpu":
        return norm_qkv_plain(x, norm_w, eps, w, bias, inv_freq, pos, cache_k, cache_v, n_heads,
                              neox)
    what = "norm_qkv"
    dev = x.device
    if dev.type != "cuda":
        _refuse(what, f"unsupported device {dev}")
    B, D = _rows(what, "x", x, dev)
    _check_norm(what, norm_w, D, dev)
    N = _check_leaf(what, w, D, dev)
    if cache_k.dim() != 4:
        _refuse(what, "the caches must be [B, S, KVH, HD]")
    Bc, S, KVH, HD = cache_k.shape
    H = n_heads
    if Bc != B or HD != HEAD_DIM or H % KVH or N != (H + 2 * KVH) * HD:
        _refuse(what, f"caches {tuple(cache_k.shape)}, {H} heads and w {tuple(w.shape)}: needs "
                      f"B = {B}, head_dim {HEAD_DIM} and N = (H + 2 KVH) head_dim")
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        _check_bf16(what, name, t, dev)
        if not t.is_contiguous() or tuple(t.shape) != (B, S, KVH, HD):
            _refuse(what, f"{name} must be contiguous [{B}, {S}, {KVH}, {HD}]")
    if bias is not None:
        _check_bf16(what, "bias", bias, dev)
        if tuple(bias.shape) != (N,) or not bias.is_contiguous():
            _refuse(what, f"bias {tuple(bias.shape)}, expected [{N}]")
    if (inv_freq.dtype != torch.float32 or inv_freq.device != dev
            or tuple(inv_freq.shape) != (HD // 2,) or not inv_freq.is_contiguous()):
        _refuse(what, f"inv_freq must be contiguous f32 [{HD // 2}] on {dev}")
    if (pos.dtype != torch.int32 or pos.device != dev or tuple(pos.shape) != (B,)
            or not pos.is_contiguous()):
        _refuse(what, f"pos must be contiguous int32 [{B}] on {dev}")
    prod_ptr = _check_prod(what, prod, B, N, dev)
    qh = torch.empty((B, KVH, H // KVH, HD), dtype=torch.bfloat16, device=dev)
    k1 = torch.empty((B, KVH, HD), dtype=torch.bfloat16, device=dev)
    v1 = torch.empty_like(k1)
    split, steps = split_k(D, N // 64)
    fn = _entry("miotts_norm_qkv_bf16",
                [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float,
                 ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8
                + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    status = build.launch(dev, fn, x.data_ptr(), D, norm_w.data_ptr(), float(eps), w.data_ptr(),
                          D, N, split, steps, None if bias is None else bias.data_ptr(),
                          inv_freq.data_ptr(), pos.data_ptr(), cache_k.data_ptr(),
                          cache_v.data_ptr(), qh.data_ptr(), k1.data_ptr(), v1.data_ptr(), B, H,
                          KVH, S, int(bool(neox)), prod_ptr, _stream(x))
    build.check(status, what)
    graphs.launched(NORM_QKV.__name__)
    return qh, k1, v1


def gemv_residual(act: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                  prod: torch.Tensor | None = None) -> None:
    """x [B, (1,) N] += act [B, (1,) K] @ w [K, N] IN PLACE, the product
    rounded to x's dtype first, as the unfused step's residual add. On CUDA
    one launch of K11 (bf16, B <= 8)."""
    if act.device.type == "cpu":
        return gemv_residual_plain(act, w, x)
    what = "gemv_residual"
    dev = act.device
    if dev.type != "cuda":
        _refuse(what, f"unsupported device {dev}")
    B, K = _rows(what, "act", act, dev)
    N = _check_leaf(what, w, K, dev)
    Bx, Nx = _rows(what, "x", x, dev)
    if (Bx, Nx) != (B, N):
        _refuse(what, f"x {tuple(x.shape)} for act {tuple(act.shape)} and w {tuple(w.shape)}")
    prod_ptr = _check_prod(what, prod, B, N, dev)
    split, steps = split_k(K, N // 64)
    fn = _entry("miotts_gemv_residual_bf16",
                [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 4
                + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p])
    status = build.launch(dev, fn, act.data_ptr(), K, w.data_ptr(), K, N, split, steps,
                          x.data_ptr(), N, B, prod_ptr, _stream(act))
    build.check(status, what)
    graphs.launched(GEMV_RESIDUAL.__name__)
    return None


def norm_gateup(x: torch.Tensor, norm_w: torch.Tensor, eps: float, w: torch.Tensor,
                ffn_dim: int, prod: torch.Tensor | None = None) -> torch.Tensor:
    """``silu_mul(rms_norm(x, norm_w, eps) @ w, ffn_dim)``: x [B, (1,) D],
    w the fused gate|up leaf [D, 2F]; returns [B, (1,) F]. On CUDA one launch
    of K11 (bf16, B <= 8, F a multiple of 32)."""
    if x.device.type == "cpu":
        return norm_gateup_plain(x, norm_w, eps, w, ffn_dim)
    what = "norm_gateup"
    dev = x.device
    if dev.type != "cuda":
        _refuse(what, f"unsupported device {dev}")
    B, D = _rows(what, "x", x, dev)
    _check_norm(what, norm_w, D, dev)
    N = _check_leaf(what, w, D, dev)
    if N != 2 * ffn_dim or ffn_dim % 32:
        _refuse(what, f"w {tuple(w.shape)} for F={ffn_dim}: needs 2F columns, F a multiple of 32")
    prod_ptr = _check_prod(what, prod, B, N, dev)
    out = torch.empty((*x.shape[:-1], ffn_dim), dtype=torch.bfloat16, device=dev)
    split, steps = split_k(D, ffn_dim // 32)
    fn = _entry("miotts_norm_gateup_bf16",
                [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float,
                 ctypes.c_void_p] + [ctypes.c_int] * 4
                + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    status = build.launch(dev, fn, x.data_ptr(), D, norm_w.data_ptr(), float(eps), w.data_ptr(),
                          D, ffn_dim, split, steps, out.data_ptr(), B, prod_ptr, _stream(x))
    build.check(status, what)
    graphs.launched(NORM_GATEUP.__name__)
    return out


def norm_head(x: torch.Tensor, norm_w: torch.Tensor, eps: float,
              head: torch.Tensor) -> torch.Tensor:
    """``dense_logits(rms_norm(x, norm_w, eps), head)``: x [B, (1,) D],
    head [V, D] (the dense head or the tied embedding); f32 logits [B, V].
    On CUDA one launch of K11 (bf16, B <= 8, D a multiple of 32)."""
    if x.device.type == "cpu":
        return norm_head_plain(x, norm_w, eps, head)
    what = "norm_head"
    dev = x.device
    if dev.type != "cuda":
        _refuse(what, f"unsupported device {dev}")
    B, D = _rows(what, "x", x, dev)
    _check_norm(what, norm_w, D, dev)
    _check_bf16(what, "head", head, dev)
    if head.dim() != 2 or head.shape[1] != D or not head.is_contiguous() or D % 32:
        _refuse(what, f"head {tuple(head.shape)} must be a contiguous [V, {D}] leaf, D a "
                      "multiple of 32")
    V = head.shape[0]
    logits = torch.empty((B, V), dtype=torch.float32, device=dev)
    fn = _entry("miotts_norm_head_bf16",
                [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p])
    status = build.launch(dev, fn, x.data_ptr(), D, norm_w.data_ptr(), float(eps),
                          head.data_ptr(), V, D, B, logits.data_ptr(), _stream(x))
    build.check(status, what)
    graphs.launched(NORM_HEAD.__name__)
    return logits
