"""MioTTS codec-token LLM (llama/Qwen-family GGUF) in PyTorch
(miotts_tpu/models/llm.py).

Prefill is one batched forward; generation runs in chunks of decode steps
with the sampler chain between them (the JAX package's resumable
``GenState`` / ``llm_start`` / chunk loop). ``chunk`` makes every chunk,
the CLI's and the server's: one body that runs its steps with no early exit
and no read back to the host, captured once as a CUDA graph and replayed
where it can be, run eagerly on the same buffers everywhere else
(``models/decode_graph.py``; ``LLMEngine`` keeps one chunk and loads each
request into it). The host reads one packed result a chunk
(``fetch_chunk_result``). Norms are f32, logits f32. Matmul weights are dense bf16 (GGUF
Q8_0/f16/f32 tensors dequantized and cast, on the host or, by the packed
route of ``runtime/device_dequant.py``, on the device) or, by the
``--llm-quant`` ladder, kept quantized on the device (``load_llm_gguf``):
Q8_0 leaves run on kernel K3 (``ops/cuda/q8_matmul.py``), W8A8 and W4A8
leaves on exact int8 dots (``ops/quant_matmul.py``).

The decode step keeps the JAX operand contract: attention reads the cache
STRICTLY below ``pos`` and takes the current token's k/v as operands; each
layer writes its row pair into the cache before its attention (JAX
scatters all layers' rows after the stack: the same cache, since no layer
reads its row at ``pos``). On one card a dense bf16 step runs as the K11
family (``ops/cuda/llm_gemv.py``, ``gemv_route``): each GEMV with the glue
on either side of it. Every other CUDA step runs its glue as the fused
kernels K7-K9 (``ops/cuda/llm_fused.py``): the residual add and RMSNorm,
the QKV bias, RoPE and cache row, and silu(gate) * up. A served step's
sampler and bookkeeping are K10 (``sample_step``).
The port updates the KV cache IN PLACE (prefill and decode step), where
JAX returns new caches. On CUDA the decode attention is kernel K2
(``ops/cuda/decode_attention.py``). Prefill attention is plain torch, as
JAX computes it outside any kernel.

The dense logits head accumulates bf16 x bf16 straight into f32 logits, as
XLA's ``preferred_element_type=f32`` does. A quantized head rounds its
logits to the activation dtype before the f32 cast, as JAX's
``_mm(...).astype(x.dtype)`` does.

Tensor parallelism (``parallel/``): wherever a weight dict goes, a
``TPGroup`` may go instead. Each of its ranks then runs its part of a layer
on its own device, in rank order: q/k/v and gate/up on its columns, K2 over
its kv heads (its part of the KV cache, which is then a tuple of the
ranks' parts), attention-out and down on its rows, each row-parallel
product summed over the group (``collectives.tp_sum``: f32 partials, or
exact int32 dots for W8A8/W4A8). The embedding and the head split over the
vocab where it divides (a masked lookup a rank, summed; logits gathered
for the sampler, which runs once on the lead). The single device is the
group of one rank: the same code, no collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import re
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..device import to_device
from ..gguf import GGUFReader
from ..ops.cuda import graphs
from ..ops.cuda.decode_attention import decode_attention
from ..ops.cuda.llm_fused import (
    add_rms_norm, qkv_rope_cache, rms_norm, rope_inv_freq, sample_step, silu_mul, write_kv_row)
from ..ops.cuda.llm_gemv import dense_logits as _dense_logits
from ..ops.cuda.llm_gemv import (
    HEAD_DIM, MAX_K, MAX_NORM_DIM, MAX_ROWS, gemv_residual, norm_gateup, norm_head, norm_qkv)
from ..ops.cuda.q8_matmul import q8_matmul
from ..ops.quant_matmul import (
    act_scale, int8_dot, int_scale, maybe_quant_matmul as _mm, quantize_int4_percol,
    quantize_int8_percol, quantize_q8_cols, row_absmax)
from ..ops.rope import apply_rope
from ..parallel.collectives import gather_vocab, to_rank, tp_max, tp_sum
from ..parallel.mesh import TPGroup
from ..runtime.device_dequant import (
    ARTIFACT_TAG, PackedLoader, _Pending, device_dequant_enabled, dtype_name,
    load_packed_artifact, packed_artifact_path, record_per_leaf)
from ..runtime.tokenizer import BPETokenizer
from . import decode_graph
from .sampling import (
    BatchSamplerParams, SamplerParams, SamplerState, sample_chain_step, sampler_key, sampler_keys)


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    arch: str
    n_layers: int
    dim: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn_dim: int
    vocab_size: int
    rms_eps: float = 1e-6
    rope_base: float = 10000.0
    rope_neox: bool = True
    context_length: int = 4096
    has_qkv_bias: bool = False
    has_qk_norm: bool = False
    tie_embeddings: bool = False


_NORM_KEYS = ("attn_norm", "ffn_norm", "output_norm", "q_norm", "k_norm")


def weights_to_device(w: dict, device: torch.device, dtype: torch.dtype) -> dict:
    """numpy weight tree -> tensors on ``device``: dense leaves ``dtype``
    (f32 -> bf16 rounds to nearest even, as JAX's astype), norms rounded to
    ``dtype`` and widened back to f32 (the JAX loader casts every dense leaf
    to ``dtype`` and only then widens the norms), and quantized leaf dicts
    with their own dtypes unchanged."""
    out = {}
    for k, v in w.items():
        if v is None:
            out[k] = None
        elif isinstance(v, dict):
            out[k] = {sk: torch.from_numpy(np.array(a)).to(device) for sk, a in v.items()}
        else:
            t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(device, dtype)
            out[k] = t.float() if k in _NORM_KEYS else t
    return out


def _quant_modes(quantize) -> dict:
    """The ``--llm-quant`` ladder (miotts_tpu/models/llm.py:144-182): which
    leaves are quantized, and how. None defers to MIOTTS_LLM_QUANT; an
    unknown value warns and loads dense."""
    if quantize is None:
        quantize = os.environ.get("MIOTTS_LLM_QUANT", "")
    if quantize in ("bf16", "none", "off"):
        quantize = ""
    combo = quantize in ("int8_output_int4", "int8+output_int4")
    layers_int8 = combo or quantize in ("int8", "w8a8")
    head_int8 = quantize in ("output_int8", "output-int8")
    head_int4 = combo or quantize in ("output_int4", "output-int4")
    layers = layers_int8 or quantize in (True, "all", "q8", "q8_0", "1")
    head = layers or head_int8 or head_int4 or quantize == "output"
    if quantize and not head and quantize is not False:
        print(f"warning: unknown MIOTTS_LLM_QUANT value {quantize!r} "
              "(expected 'int8', 'all', 'q8', 'output', 'output_int8', "
              "'output_int4' or 'int8_output_int4'); running dense", file=sys.stderr)
    return {"requested": quantize, "layers": layers,
            "layer_kind": "int8" if layers_int8 else "q8_0", "head": head,
            "head_kind": ("int4" if head_int4 else "int8" if layers_int8 or head_int8
                          else "q8_0")}


def quantize_kn(wkn: np.ndarray, kind: str) -> dict:
    """Quantize a transposed [K, N] weight into a leaf dict of ``kind``
    "q8_0" ({"q", "s"}), "int8" ({"q8", "s8"}) or "int4" ({"q4i8", "s4"}).
    N is padded to a multiple of 128; callers slice outputs back to the
    true width (miotts_tpu/models/llm.py:215-239)."""
    K, N = wkn.shape
    Np = ((N + 127) // 128) * 128
    if Np != N:
        wkn = np.pad(wkn, ((0, 0), (0, Np - N)))
    if kind == "int4":
        q4, s4 = quantize_int4_percol(wkn)
        return {"q4i8": q4, "s4": s4}
    if kind == "int8":
        q8, s8 = quantize_int8_percol(wkn)
        return {"q8": q8, "s8": s8}
    q, s = quantize_q8_cols(wkn)
    return {"q": q, "s": s}


def _warn_tied_quant_noop(head_quant_requested: bool, quantize) -> None:
    """Tied-embedding models have no output.weight, so a head-quant request
    cannot apply: the logits reuse the dense token embedding. Warn instead
    of serving dense silently. Returns None (the tied head's leaf)."""
    if head_quant_requested:
        print(f"warning: --llm-quant {quantize!r} cannot quantize the "
              "logits head of a tied-embedding model (no output.weight; "
              "the head reuses the dense token embedding)", file=sys.stderr)
    return None


def _replay_llm(art, device: torch.device) -> dict | None:
    """The weight tree replayed from a deploy artifact, or None."""
    loaded = load_packed_artifact(art, device)
    if loaded is None or not loaded[1]:
        return None
    built, wspec = loaded
    try:
        return {k: (None if v is None else {sk: built[key] for sk, key in v[1].items()}
                    if v[0] == "dict" else built[v[1]])
                for k, v in wspec.items()}
    except KeyError:
        return None


def load_llm_gguf(path: str, device: torch.device, dtype: torch.dtype = torch.bfloat16,
                  quantize=None) -> tuple[LLMConfig, dict, BPETokenizer]:
    """Every tensor is dequantized to f32 on the host and matmul weights are
    transposed to [in, out] with q|k|v and gate|up fused column-wise
    (``MIOTTS_LLM_FUSE=0``: one leaf a projection, wq/wk/wv, w_gate/w_up
    and their biases bq/bk/bv). By
    ``quantize`` (``_quant_modes``) the matmul leaves and the head are then
    quantized on the host as the JAX loader does them (``quantize_kn``, the
    head from its [D, V] transpose); dense leaves are cast to ``dtype``. A
    dense logits head stays [V, D] (None when tied to the embedding).

    Where ``device_dequant_enabled`` (CUDA by default), the weights take the
    packed route (``runtime/device_dequant.py``): the embedding, a dense
    head and the dense matmul leaves ship their GGUF payload (Q8_0, Q4_0 or
    F16) and are dequantized, transposed and fused on the device; every
    other leaf is pre-cast on the host; all of it in one copy a dtype, with
    the same bits as the per-leaf route. With MIOTTS_PACKED_CACHE set, the
    packed buffers are kept as a deploy artifact, looked up before any
    tensor is read."""
    mode = _quant_modes(quantize)
    # fused q|k|v and gate|up leaves by default; MIOTTS_LLM_FUSE=0 keeps one
    # leaf a projection, as the JAX loader (miotts_tpu/models/llm.py:277-280)
    fuse = os.environ.get("MIOTTS_LLM_FUSE", "1") not in ("0", "off")
    device = torch.device(device)
    pk = PackedLoader(device) if device_dequant_enabled(device) else None
    with GGUFReader(path) as r:
        arch = r.get_str("general.architecture")
        if arch is None:
            raise ValueError("GGUF missing general.architecture")

        def kv(key, default=None):
            return r.kv.get(f"{arch}.{key}", default)

        n_layers = int(kv("block_count"))
        dim = int(kv("embedding_length"))
        n_heads = int(kv("attention.head_count"))
        tokenizer = BPETokenizer.from_gguf_kv(r.kv)
        cfg = LLMConfig(
            arch=arch, n_layers=n_layers, dim=dim, n_heads=n_heads,
            n_kv_heads=int(kv("attention.head_count_kv", n_heads)),
            head_dim=int(kv("attention.key_length", dim // n_heads)),
            ffn_dim=int(kv("feed_forward_length")),
            vocab_size=len(tokenizer.tokens),
            rms_eps=float(kv("attention.layer_norm_rms_epsilon", 1e-6)),
            rope_base=float(kv("rope.freq_base", 10000.0)),
            rope_neox=arch not in ("llama",),
            context_length=int(kv("context_length", 4096)),
            has_qkv_bias=r.has_tensor("blk.0.attn_q.bias"),
            has_qk_norm=r.has_tensor("blk.0.attn_q_norm.weight"),
            tie_embeddings=not r.has_tensor("output.weight"),
        )
        art = None
        if pk is not None:
            art = packed_artifact_path(
                path, f"llm|{dtype_name(dtype)}|{mode['requested']}|{ARTIFACT_TAG}"
                + ("" if fuse else "|unfused"))
            if art is not None and art.exists():
                w = _replay_llm(art, device)
                if w is not None:
                    return cfg, w, tokenizer

        def t(name, transpose=False):
            arr = r.tensor(name, dtype=np.float32)
            return np.ascontiguousarray(arr.T) if transpose else arr

        def raw(fmts, stacked=False):
            """A dense leaf from its GGUF payload on the packed route (None
            when that route is off or a tensor's type has no device dequant)."""
            if pk is None:
                return None
            return pk.add_raw(("raw", fmts[0]), r, fmts, n_layers if stacked else None,
                              transpose=stacked, out_dtype=dtype)

        def stack_layers(per_layer, quant):
            if not (quant and mode["layers"]):
                return np.stack(per_layer)
            leaves = [quantize_kn(a, mode["layer_kind"]) for a in per_layer]
            return {k: np.stack([leaf[k] for leaf in leaves]) for k in leaves[0]}

        def stack(fmt, transpose=False, quant=False):
            return stack_layers([t(fmt.format(i=i), transpose) for i in range(n_layers)], quant)

        def matmul(fmts):
            """A layer-stacked matmul leaf, [L, in, sum(out)]."""
            if not mode["layers"]:
                p = raw(fmts, stacked=True)
                if p is not None:
                    return p
            return stack_layers([np.concatenate([t(f.format(i=i), True) for f in fmts], axis=1)
                                 for i in range(n_layers)], quant=True)

        if cfg.tie_embeddings:
            head = _warn_tied_quant_noop(mode["head"], mode["requested"])
        elif mode["head"]:
            head = quantize_kn(t("output.weight", transpose=True), mode["head_kind"])
        else:
            head = raw(["output.weight"]) or t("output.weight")
        qkv = [f"blk.{{i}}.attn_{p}.weight" for p in "qkv"]
        gateup = ["blk.{i}.ffn_gate.weight", "blk.{i}.ffn_up.weight"]
        if fuse:
            attn = {"wqkv": matmul(qkv), "bqkv": (
                np.stack([np.concatenate([t(f"blk.{i}.attn_{p}.bias") for p in "qkv"])
                          for i in range(n_layers)]) if cfg.has_qkv_bias else None)}
            ffn = {"w_gateup": matmul(gateup)}
        else:
            attn = {f"w{p}": matmul([fmt]) for p, fmt in zip("qkv", qkv)}
            attn.update({f"b{p}": stack(f"blk.{{i}}.attn_{p}.bias") if cfg.has_qkv_bias
                         else None for p in "qkv"})
            ffn = {"w_gate": matmul(gateup[:1]), "w_up": matmul(gateup[1:])}
        w = {
            "token_embd": raw(["token_embd.weight"]) or t("token_embd.weight"),
            "attn_norm": stack("blk.{i}.attn_norm.weight"),
            **attn,
            "wo": matmul(["blk.{i}.attn_output.weight"]),
            "ffn_norm": stack("blk.{i}.ffn_norm.weight"),
            **ffn,
            "w_down": matmul(["blk.{i}.ffn_down.weight"]),
            "q_norm": stack("blk.{i}.attn_q_norm.weight") if cfg.has_qk_norm else None,
            "k_norm": stack("blk.{i}.attn_k_norm.weight") if cfg.has_qk_norm else None,
            "output_norm": t("output_norm.weight"),
            "output": head,
        }
    if pk is None:
        t0 = time.perf_counter()
        out = weights_to_device(w, device, dtype)
        record_per_leaf(time.perf_counter() - t0, sum(
            a.nbytes for v in out.values() if v is not None
            for a in (v.values() if isinstance(v, dict) else (v,))))
        return cfg, out, tokenizer
    return cfg, _finalize_packed(pk, w, dtype, art), tokenizer


def _finalize_packed(pk: PackedLoader, w: dict, dtype: torch.dtype, art) -> dict:
    """Stage the host-built leaves beside the raw ones, exactly as
    ``weights_to_device`` would place them (quantized dicts in their own
    dtypes, dense leaves cast to ``dtype``, norms rounded to ``dtype`` and
    widened to f32), then build them all in one upload, allocated in the
    per-leaf route's order."""
    for k, v in w.items():
        if v is None or isinstance(v, _Pending):
            continue
        if isinstance(v, dict):
            w[k] = {sk: pk.add_array(("arr", k, sk), np.array(a)) for sk, a in v.items()}
        elif k in _NORM_KEYS:
            rounded = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(dtype)
            w[k] = pk.add_array(("arr", k), rounded.float().numpy())
        else:
            w[k] = pk.add_array(("arr", k), v, out_dtype=dtype)
    wspec = {k: (None if v is None else ("dict", {sk: sv.key for sk, sv in v.items()})
                 if isinstance(v, dict) else ("leaf", v.key))
             for k, v in w.items()}
    order = [p.key for v in w.values() if v is not None
             for p in (v.values() if isinstance(v, dict) else (v,))]
    built = pk.finalize(artifact_path=art, extra_meta=wspec, order=order)
    return {k: (None if v is None else {sk: built[sv.key] for sk, sv in v.items()}
                if isinstance(v, dict) else built[v.key])
            for k, v in w.items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _head_logits(cfg: LLMConfig, w: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, D] -> f32 logits [B, V] from one weight dict. A dense head is
    [V, D] (or the tied embedding); a quantized head is a [D, V]-derived
    leaf whose padded columns are sliced off."""
    head = w["output"] if w["output"] is not None else w["token_embd"]
    if isinstance(head, dict):
        return _mm(x, head).float()[..., :cfg.vocab_size]
    return _dense_logits(x, head)


# ---------------------------------------------------------------------------
# tensor parallelism: each rank of a TPGroup runs its part of a layer
# ---------------------------------------------------------------------------

def _ranks(cfg: LLMConfig, w) -> tuple[list, list, TPGroup | None]:
    """(rank configs, rank weight dicts, group): a ``TPGroup``'s ranks, or
    one weight dict (or None) as the single rank of no group."""
    if isinstance(w, TPGroup):
        return w.cfgs, w.shards, w
    return [cfg], [w], None


def _to(g: TPGroup | None, t: torch.Tensor, r: int) -> torch.Tensor:
    """``t`` on rank r's device (without a group, ``t`` itself)."""
    return t if g is None else to_rank(t, g.devices[r])


def _rank_scope(g: TPGroup | None, r: int):
    """Rank r's kernel launches count for its logical device."""
    return contextlib.nullcontext() if g is None else graphs.on_rank(g.ranks[r].id)


def kv_parts(cache) -> tuple:
    """A KV cache's parts: a tensor-parallel cache's tuple (one part a
    rank), or (cache,)."""
    return cache if isinstance(cache, tuple) else (cache,)


def _kv_join(parts: list):
    """Rank parts of a KV cache as the cache: one tensor, or a tuple."""
    return parts[0] if len(parts) == 1 else tuple(parts)


def kv_map(fn, cache):
    """``fn`` applied to every part of a KV cache, keeping its form."""
    return _kv_join([fn(c) for c in kv_parts(cache)])


def spans_devices(w) -> bool:
    """Whether ``w`` is a tensor-parallel group over more than one card:
    its chunks run eagerly, not as one CUDA graph."""
    return isinstance(w, TPGroup) and not w.one_device


def _mm_f32(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w -> [..., N] in f32, not rounded to x's dtype: a rank's
    partial result of a row-parallel matmul (dense or Q8_0)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, dict):
        return q8_matmul(x2.contiguous(), w["q"], w["s"]).reshape(*lead, -1)
    if x.dtype == torch.float32:
        y = x2 @ w
    elif x.device.type == "cuda":
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float()
    return y.reshape(*lead, -1)


def _row_parallel(g: TPGroup | None, acts: list, blks: list, key: str) -> torch.Tensor:
    """The row-parallel matmul: rank r's activation ``acts[r]`` times its
    ``key`` leaf, summed over the group (``tp_sum``) in the activation's
    dtype. A W8A8/W4A8 leaf quantizes the activations with one scale a row
    over the whole K (the group's max, as the single device does) and sums
    the ranks' int32 dots exactly before it scales them: bit for bit the
    single device's product. Without a group, the one matmul."""
    if g is None:
        return _mm(acts[0], blks[0][key])
    leaves = [b[key] for b in blks]
    if not isinstance(leaves[0], dict) or "q" in leaves[0]:
        parts = []
        for r, (a, leaf) in enumerate(zip(acts, leaves)):
            with _rank_scope(g, r):
                parts.append(_mm_f32(a, leaf))
        return tp_sum(parts, g.lead, acts[0].dtype)
    sx = act_scale(tp_max([row_absmax(a) for a in acts], g.lead))
    dots = []
    for r, (a, leaf) in enumerate(zip(acts, leaves)):
        with _rank_scope(g, r):
            q = next(leaf[k] for k in ("q8", "q4", "q4i8") if k in leaf)
            dots.append(int8_dot(a, q, _to(g, sx, r))[0])
    scale = leaves[0]["s8"] if "s8" in leaves[0] else leaves[0]["s4"]
    dot = tp_sum(dots, g.lead, torch.int32)
    return int_scale(dot, sx, scale, acts[0].shape[:-1]).to(acts[0].dtype)


def _embed(cfg: LLMConfig, w, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings [..., D], on the lead device: one lookup, or, with
    the vocab split over a group, a masked lookup a rank and their sum
    (exact: only the rank holding a token's row gives it a nonzero one)."""
    _, shards, g = _ranks(cfg, w)
    if g is None or not g.embd_split:
        return shards[0]["token_embd"][tokens.long()]
    parts = []
    for r, sh in enumerate(shards):
        emb = sh["token_embd"]
        n = emb.shape[0]
        local = _to(g, tokens, r).long() - r * n
        hit = (local >= 0) & (local < n)
        parts.append(emb[local.clamp(0, n - 1)] * hit[..., None].to(emb.dtype))
    return tp_sum(parts, g.lead, shards[0]["token_embd"].dtype)


def _logits(cfg: LLMConfig, w, x: torch.Tensor) -> torch.Tensor:
    """x [B, D] -> f32 logits [B, V] (``_head_logits``). With the head
    split over a group's vocab, each rank's logits are gathered on the lead
    device, where the sampler runs."""
    _, shards, g = _ranks(cfg, w)
    if g is None or not g.head_split:
        with _rank_scope(g, 0):
            return _head_logits(cfg, shards[0], x)
    parts = []
    for r, sh in enumerate(shards):
        with _rank_scope(g, r):
            head = sh["output"] if sh["output"] is not None else sh["token_embd"]
            xr = _to(g, x, r)
            parts.append(_mm(xr, head).float() if isinstance(head, dict)
                         else _dense_logits(xr, head))
    return gather_vocab(parts, g.lead)[..., :cfg.vocab_size]


_BLK_KEYS = ("attn_norm", "wqkv", "bqkv", "wq", "wk", "wv", "bq", "bk", "bv", "wo", "ffn_norm",
             "w_gateup", "w_gate", "w_up", "w_down", "q_norm", "k_norm")


def _layer(w: dict, li: int) -> dict:
    """Layer ``li``'s slice of the stacked per-layer leaves (None for a
    leaf the weights do not have: fused or per-projection ones)."""
    def pick(v):
        if v is None:
            return None
        return {k: a[li] for k, a in v.items()} if isinstance(v, dict) else v[li]
    return {k: pick(w.get(k)) for k in _BLK_KEYS}


def _layer_qkv(cfg: LLMConfig, blk: dict, xn: torch.Tensor):
    Hd = cfg.n_heads * cfg.head_dim
    KVd = cfg.n_kv_heads * cfg.head_dim
    # quantized leaves are padded along N: slice before the bias add
    if blk["wqkv"] is not None:
        qkv = _mm(xn, blk["wqkv"])[..., :Hd + 2 * KVd]
        if blk["bqkv"] is not None:
            qkv = qkv + blk["bqkv"]
        q, k, v = qkv[..., :Hd], qkv[..., Hd:Hd + KVd], qkv[..., Hd + KVd:]
    else:
        q = _mm(xn, blk["wq"])[..., :Hd]
        k = _mm(xn, blk["wk"])[..., :KVd]
        v = _mm(xn, blk["wv"])[..., :KVd]
        if blk["bq"] is not None:
            q, k, v = q + blk["bq"], k + blk["bk"], v + blk["bv"]
    B, T = xn.shape[:2]
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    if blk["q_norm"] is not None:
        q = rms_norm(q, blk["q_norm"], cfg.rms_eps)
        k = rms_norm(k, blk["k_norm"], cfg.rms_eps)
    return q, k, v


def _ffn_act(cfg: LLMConfig, blk: dict, fn: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up of the normed input ``fn``, as plain expressions."""
    if blk["w_gateup"] is not None:
        gu = _mm(fn, blk["w_gateup"])
        gate, up = gu[..., :cfg.ffn_dim], gu[..., cfg.ffn_dim:2 * cfg.ffn_dim]
    else:
        gate = _mm(fn, blk["w_gate"])[..., :cfg.ffn_dim]
        up = _mm(fn, blk["w_up"])[..., :cfg.ffn_dim]
    return F.silu(gate) * up


def _ffn(cfg: LLMConfig, cfgs: list, g: TPGroup | None, blks: list,
         x: torch.Tensor) -> torch.Tensor:
    """The MLP block: each rank's gate/up columns, then down row-parallel."""
    acts = []
    for r, (rc, blk) in enumerate(zip(cfgs, blks)):
        with _rank_scope(g, r):
            acts.append(_ffn_act(rc, blk, rms_norm(_to(g, x, r), blk["ffn_norm"], cfg.rms_eps)))
    return _row_parallel(g, acts, blks, "w_down")[..., :cfg.dim]


def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int, device: torch.device,
                  dtype: torch.dtype = torch.bfloat16, w=None):
    """[L, B, S, KVH, HD] zeros; bf16 whatever the weights' dtype, as JAX.
    For a tensor-parallel group ``w``, a tuple of each rank's part (its kv
    heads, on its device)."""
    cfgs, _, g = _ranks(cfg, w)
    parts = []
    for r, rc in enumerate(cfgs):
        shape = (cfg.n_layers, batch, max_len, rc.n_kv_heads, cfg.head_dim)
        parts.append(torch.zeros(shape, dtype=dtype, device=device if g is None
                                 else g.devices[r]))
    return _kv_join(parts), kv_map(torch.zeros_like, _kv_join(parts))


def llm_prefill_kv(cfg: LLMConfig, w, tokens: torch.Tensor, lengths: torch.Tensor):
    """Padded prompts [B, T] at positions 0..T-1 -> (last-valid-token logits
    [B, V] f32, prompt K [L, B, T, KVH, HD], prompt V). Rows at
    t >= lengths[b] carry garbage K/V that decode never reads (it masks keys
    at positions >= pos). ``w`` is a weight dict or a ``TPGroup``, whose
    K/V come back as a tuple of each rank's kv heads."""
    cfgs, shards, g = _ranks(cfg, w)
    B, T = tokens.shape
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)
    x = _embed(cfg, w, tokens)
    t_idx = torch.arange(T, device=dev)
    causal = t_idx[:, None] >= t_idx[None, :]
    valid_k = t_idx[None, :] < lengths[:, None]
    mask = (causal[None] & valid_k[:, None, :])[:, None]  # [B, 1, Tq, Tk]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    pos_rs = [_to(g, positions, r) for r in range(len(shards))]
    mask_rs = [_to(g, mask, r) for r in range(len(shards))]

    new_k, new_v = [[] for _ in shards], [[] for _ in shards]
    for li in range(cfg.n_layers):
        blks, acts = [], []
        for r, (rc, sh) in enumerate(zip(cfgs, shards)):
            with _rank_scope(g, r):
                blk = _layer(sh, li)
                q, k, v = _layer_qkv(rc, blk, rms_norm(_to(g, x, r), blk["attn_norm"],
                                                       cfg.rms_eps))
                q = apply_rope(q, pos_rs[r], cfg.rope_base, cfg.rope_neox)
                k = apply_rope(k, pos_rs[r], cfg.rope_base, cfg.rope_neox)
                new_k[r].append(k)
                new_v[r].append(v)
                group = rc.n_heads // rc.n_kv_heads
                kr = k.repeat_interleave(group, dim=2)
                vr = v.repeat_interleave(group, dim=2)
                scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
                probs = torch.softmax(scores.masked_fill(~mask_rs[r], float("-inf")),
                                      dim=-1).to(x.dtype)
                acts.append(torch.einsum("bhqk,bkhd->bqhd", probs, vr).reshape(B, T, -1))
                blks.append(blk)
        x = x + _row_parallel(g, acts, blks, "wo")[..., :cfg.dim]
        x = x + _ffn(cfg, cfgs, g, blks, x)

    xn = rms_norm(x, shards[0]["output_norm"], cfg.rms_eps)
    last = torch.clamp(lengths.long() - 1, min=0)
    xn_last = xn[torch.arange(B, device=dev), last]  # [B, D]
    return (_logits(cfg, w, xn_last), _kv_join([torch.stack(k) for k in new_k]),
            _kv_join([torch.stack(v) for v in new_v]))


def llm_prefill(cfg: LLMConfig, w, tokens: torch.Tensor, lengths: torch.Tensor,
                cache_k, cache_v) -> torch.Tensor:
    """Prefill and write K/V at [0, length) of each lane's cache IN PLACE
    (writes past the cache end are dropped). Returns the last valid
    token's logits [B, V]."""
    S = kv_parts(cache_k)[0].shape[2]
    last, new_k, new_v = llm_prefill_kv(cfg, w, tokens, lengths)
    pairs = list(zip(kv_parts(cache_k) + kv_parts(cache_v),
                     kv_parts(new_k) + kv_parts(new_v)))
    for b, n in enumerate(lengths.tolist()):
        n = max(0, min(int(n), S))
        for cache, new in pairs:
            cache[:, b, :n] = new[:, b, :n].to(cache.dtype)
    return last


def _decode_qkv(cfg: LLMConfig, blk: dict, h: torch.Tensor, pos: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor):
    """One rank's decode-step attention operands from the normed input h
    [B, 1, D]: (qh [B, KVH, G, HD], k1, v1 [B, KVH, HD]) for K2, with this
    step's k/v written into row ``pos`` of the layer's cache (``cache_k``
    [B, S, KVH, HD]) IN PLACE. A layer with the fused q|k|v leaf and no
    q_norm/k_norm takes ``qkv_rope_cache`` (K8 on CUDA) after its GEMM;
    any other keeps the unfused expressions."""
    if blk["wqkv"] is not None and blk["q_norm"] is None:
        inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_base, h.device)
        return qkv_rope_cache(_mm(h, blk["wqkv"]), blk["bqkv"], inv_freq, pos, cache_k, cache_v,
                              cfg.n_heads, cfg.rope_neox)
    positions = pos[:, None]
    q, k, v = _layer_qkv(cfg, blk, h)
    q = apply_rope(q, positions, cfg.rope_base, cfg.rope_neox)
    k = apply_rope(k, positions, cfg.rope_base, cfg.rope_neox)
    # rounded to the cache dtype first: attention sees exactly the values
    # the cache stores
    k1 = k[:, 0].to(cache_k.dtype).contiguous()
    v1 = v[:, 0].to(cache_v.dtype).contiguous()
    qh = q[:, 0].reshape(h.shape[0], cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                         cfg.head_dim).contiguous()
    write_kv_row(cache_k, cache_v, k1, v1, pos)
    return qh, k1, v1


def _decode_ffn_act(cfg: LLMConfig, blk: dict, h: torch.Tensor) -> torch.Tensor:
    """One rank's MLP activation silu(gate) * up from the normed input h:
    ``silu_mul`` (K9 on CUDA) over the fused gate|up product, or the
    unfused expressions."""
    if blk["w_gateup"] is not None:
        return silu_mul(_mm(h, blk["w_gateup"]), cfg.ffn_dim)
    return _ffn_act(cfg, blk, h)


def _bf16_leaf(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16


def gemv_route(cfg: LLMConfig, w, rows: int, device) -> bool:
    """Whether a decode step of ``rows`` lanes on ``device`` takes the K11
    family (``_decode_step_gemv``), from what the step can observe: a CUDA
    device, no ``TPGroup`` (whose row-parallel sums sit between a product
    and the residual add), dense bf16 layer leaves with the fused q|k|v and
    gate|up leaves, no q_norm, at most 8 rows, and shapes the kernels take
    (head_dim 64, widths within their limits). Every other step keeps the
    K7-K9 route."""
    if torch.device(device).type != "cuda" or isinstance(w, TPGroup) or not 1 <= rows <= MAX_ROWS:
        return False
    if w.get("q_norm") is not None or not all(
            _bf16_leaf(w.get(k)) for k in ("wqkv", "wo", "w_gateup", "w_down", "token_embd")):
        return False
    return (cfg.head_dim == HEAD_DIM and cfg.dim % 64 == 0 and cfg.dim <= MAX_NORM_DIM
            and cfg.ffn_dim % 32 == 0 and max(cfg.ffn_dim, cfg.n_heads * cfg.head_dim) <= MAX_K)


def _decode_step_gemv(cfg: LLMConfig, w: dict, token: torch.Tensor, pos: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor) -> torch.Tensor:
    """``llm_decode_step`` on the K11 family (``ops/cuda/llm_gemv.py``): a
    layer is ``norm_qkv`` -> K2 -> ``gemv_residual`` (wo) -> ``norm_gateup``
    -> ``gemv_residual`` (down), the residual stream x updated in place; the
    step ends with ``norm_head`` on a dense head, or the output norm (K7)
    and ``_head_logits`` on a quantized one. Taken where ``gemv_route``
    says so; on the CPU each call is its plain version, the unfused
    step's expressions."""
    x = _embed(cfg, w, token)[:, None, :]  # [B, 1, D], the residual stream
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_base, x.device)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for li in range(cfg.n_layers):
        ck, cv = cache_k[li], cache_v[li]
        qh, k1, v1 = norm_qkv(x, w["attn_norm"][li], cfg.rms_eps, w["wqkv"][li],
                              None if w["bqkv"] is None else w["bqkv"][li], inv_freq, pos, ck, cv,
                              cfg.n_heads, cfg.rope_neox)
        att = decode_attention(qh, k1, v1, ck, cv, scale, pos)[:, None, :]
        gemv_residual(att, w["wo"][li], x)
        act = norm_gateup(x, w["ffn_norm"][li], cfg.rms_eps, w["w_gateup"][li], cfg.ffn_dim)
        gemv_residual(act, w["w_down"][li], x)
    head = w["output"] if w["output"] is not None else w["token_embd"]
    if _bf16_leaf(head):
        return norm_head(x, w["output_norm"], cfg.rms_eps, head)
    return _head_logits(cfg, w, add_rms_norm(x, None, w["output_norm"], cfg.rms_eps)[:, 0])


def llm_decode_step(cfg: LLMConfig, w, token: torch.Tensor, pos: torch.Tensor,
                    cache_k, cache_v) -> torch.Tensor:
    """One decode step for lanes token/pos [B] (pos int32). Returns logits
    [B, V] f32; this step's k/v land in the cache at ``pos`` IN PLACE, each
    layer's row before its attention, which reads the cache below pos
    only (a pos past the cache end writes nothing). The residual stream x
    lives on the lead device, where each residual add and the norm after it
    run as one ``add_rms_norm`` (K7 on CUDA), whose output goes to each
    rank; for a ``TPGroup`` each rank runs K8 and K2 over its own kv heads
    (its part of the cache) and its own leaf shards, with the sums of
    ``_row_parallel`` between. Where ``gemv_route`` says so, the step runs
    on the K11 family instead (``_decode_step_gemv``)."""
    if gemv_route(cfg, w, token.shape[0], token.device):
        return _decode_step_gemv(cfg, w, token, pos, cache_k, cache_v)
    cfgs, shards, g = _ranks(cfg, w)
    ck, cv = kv_parts(cache_k), kv_parts(cache_v)
    x = _embed(cfg, w, token)[:, None, :]  # [B, 1, D], the residual stream
    pos_rs = [_to(g, pos, r) for r in range(len(shards))]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    lead = shards[0]

    delta = None  # the last block's output, added to x by the next norm
    for li in range(cfg.n_layers):
        h = add_rms_norm(x, delta, lead["attn_norm"][li], cfg.rms_eps)
        blks, acts = [], []
        for r, (rc, sh) in enumerate(zip(cfgs, shards)):
            with _rank_scope(g, r):
                blk = _layer(sh, li)
                qh, k1, v1 = _decode_qkv(rc, blk, _to(g, h, r), pos_rs[r], ck[r][li], cv[r][li])
                att = decode_attention(qh, k1, v1, ck[r][li], cv[r][li], scale,
                                       pos_rs[r]).to(x.dtype)
                acts.append(att[:, None, :])
                blks.append(blk)
        h = add_rms_norm(x, _row_parallel(g, acts, blks, "wo")[..., :cfg.dim],
                         lead["ffn_norm"][li], cfg.rms_eps)
        acts = []
        for r, (rc, blk) in enumerate(zip(cfgs, blks)):
            with _rank_scope(g, r):
                acts.append(_decode_ffn_act(rc, blk, _to(g, h, r)))
        delta = _row_parallel(g, acts, blks, "w_down")[..., :cfg.dim]

    xn = add_rms_norm(x, delta, lead["output_norm"], cfg.rms_eps)
    return _logits(cfg, w, xn[:, 0])


# ---------------------------------------------------------------------------
# resumable chunked generation
# ---------------------------------------------------------------------------

CHUNK = 16  # decode steps a chunk runs (the JAX package's streaming chunk)


@dataclasses.dataclass
class GenState:
    """Carry state between generation chunks (miotts_tpu/models/llm.py
    GenState): device tensors the chunk body updates IN PLACE. A chunk
    keeps the state it was made on as its buffers (``decode_graph.Chunk``)."""
    logits: torch.Tensor  # [B, V] f32, the logits of the next sample
    # [L, B, S, KVH, HD]; for a TPGroup a tuple, each rank's kv heads
    cache_k: torch.Tensor | tuple
    cache_v: torch.Tensor | tuple
    pos: torch.Tensor  # [B] int32, the next cache write position
    ring: torch.Tensor  # [B, 64] int64 sampler penalty ring
    ring_idx: torch.Tensor  # [] int32 ring cursor
    done: torch.Tensor  # [B] bool
    key: torch.Tensor  # [2] int64 sampler key: seed, draws so far (JAX: the PRNG key)

    def head(self, T: int) -> "GenState":
        """A copy of this state with its cache's first T rows (the ring
        cursor shared)."""
        return GenState(self.logits.clone(), kv_map(lambda c: c[:, :, :T].clone(), self.cache_k),
                        kv_map(lambda c: c[:, :, :T].clone(), self.cache_v), self.pos.clone(),
                        self.ring.clone(), self.ring_idx, self.done.clone(), self.key.clone())


def llm_start(cfg: LLMConfig, w: dict, prompt_tokens: torch.Tensor,
              prompt_lengths: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
              key: torch.Tensor) -> GenState:
    """Prefill (eagerly; it writes the prompt's K/V into ``cache_k``/
    ``cache_v`` in place) and the state of a first chunk, drawing from a
    copy of ``key`` (``sampler_key``)."""
    logits = llm_prefill(cfg, w, prompt_tokens, prompt_lengths, cache_k, cache_v)
    B = prompt_tokens.shape[0]
    s0 = SamplerState.init(B, prompt_tokens.device)
    return GenState(logits.contiguous(), cache_k, cache_v,
                    prompt_lengths.to(torch.int32).clone(), s0.ring, s0.idx,
                    torch.zeros((B,), dtype=torch.bool, device=prompt_tokens.device), key.clone())


def empty_gen_state(cfg: LLMConfig, B: int, S: int, device: torch.device, w=None) -> GenState:
    """A zeroed state of B lanes over a cache of S rows: the buffers a chunk
    is made on before any request is loaded into them. ``device`` is the
    lead device of a ``TPGroup`` ``w``, whose cache is split."""
    ck, cv = init_kv_cache(cfg, B, S, device, w=w)
    s0 = SamplerState.init(B, device)
    return GenState(torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=device),
                    ck, cv, torch.zeros((B,), dtype=torch.int32, device=device), s0.ring,
                    s0.idx, torch.zeros((B,), dtype=torch.bool, device=device),
                    sampler_key(0, device))


def _chunk_body(cfg: LLMConfig, w: dict, eog_ids: torch.Tensor, n_steps: int, step,
                sampler, rem: torch.Tensor | None, state: GenState, out: torch.Tensor,
                n_new: torch.Tensor) -> None:
    """``n_steps`` decode steps from ``state``, IN PLACE, with no early exit
    and no read back to the host (miotts_tpu/models/llm.py:891
    ``_chunk_loop_batched``): the body a chunk runs eagerly or captures. A
    step's sampler and bookkeeping are one call of ``step``: ``sample_step``
    for the server's lanes (K10 on CUDA; per-lane settings and keys) or
    ``sampling.sample_chain_step`` for the CLI's (one ``SamplerParams``,
    one key), either of which writes ``out``'s column and updates
    ``state.done`` and ``n_new`` in place. ``rem`` [B] int32 is each lane's
    remaining budget (None: none): a lane whose ``rem``-th token of this
    chunk was just emitted is done, as after an EOG; the chunk of an
    ``n_steps`` rung stands in for JAX's run-time ``step_cap``. A done lane
    emits 0, keeps its pos and does not count, as the JAX body does; its
    decode step still runs (its k/v land at its unchanging pos)."""
    sstate = SamplerState(state.ring, state.ring_idx)
    n_new.zero_()
    for s in range(n_steps):
        tok, adv = step(state.logits, sampler, sstate, state.key, eog_ids, rem, state.done, n_new,
                        out[:, s])
        state.logits.copy_(llm_decode_step(cfg, w, tok, state.pos, state.cache_k, state.cache_v))
        state.pos.add_(adv)


def _chunk_body_sliced(cfg: LLMConfig, w: dict, eog_ids: torch.Tensor, n_steps: int,
                       sampler: BatchSamplerParams, rem: torch.Tensor, lanes: torch.Tensor,
                       state: GenState, out: torch.Tensor, n_new: torch.Tensor) -> None:
    """The width-sliced chunk (miotts_tpu/models/llm.py:978-1049), IN
    PLACE: gather the lanes of
    ``lanes`` [w] into a width-w sub-state, run ``_chunk_body`` on it with
    the gathered sampler settings and budgets, and scatter it back into
    ``state``. ``out`` [B, n_steps] and ``n_new`` [B] stay full width, zero
    outside the gathered lanes, so delivery reads them as it reads a
    full-width chunk. The ring cursor is the state's, advanced as the
    full-width chunk advances it, so a live lane's tokens are the
    full-width chunk's.

    Pad rows. JAX pads ``lanes`` with the out-of-range lane B and drops
    their writes (``mode="drop"``). ``index_copy_`` has no drop mode, and
    duplicate indices leave its result undefined, so here a pad row names
    a DISTINCT lane outside the live set, written ``B + lane``: that lane's
    row is gathered, forced done from the first step (it emits nothing and
    keeps its pos), and written back. A width below the lane count always
    leaves enough such lanes: w < B lanes cover at most w live ones and
    need w - live pads, and B - live >= w - live lanes are not live. The
    write-back changes only lanes that hold no running request (free, or
    reserved with their attach still to come): the next use of such a lane
    is an attach, which rewrites its logits, pos, ring, done, key and the
    cache below its new pos, and decode writes every cache row at or above
    pos before it reads it."""
    B = state.pos.shape[0]
    pad = lanes >= B
    idx = torch.where(pad, lanes - B, lanes)

    def take(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t.index_select(dim, idx)

    def take_kv(cache):
        return kv_map(lambda c: c.index_select(1, idx.to(c.device)), cache)

    sub = GenState(take(state.logits), take_kv(state.cache_k), take_kv(state.cache_v),
                   take(state.pos), take(state.ring), state.ring_idx, take(state.done) | pad,
                   take(state.key))
    sub_sampler = BatchSamplerParams(take(sampler.temp), take(sampler.top_k),
                                     take(sampler.top_p), take(sampler.repeat_penalty))
    width = lanes.shape[0]
    out_w = torch.empty((width, n_steps), dtype=out.dtype, device=out.device)
    n_new_w = torch.empty((width,), dtype=n_new.dtype, device=n_new.device)
    _chunk_body(cfg, w, eog_ids, n_steps, sample_step, sub_sampler, take(rem), sub, out_w,
                n_new_w)
    for name in ("logits", "pos", "ring", "done", "key"):
        getattr(state, name).index_copy_(0, idx, getattr(sub, name))
    for cache, new in zip(kv_parts(state.cache_k) + kv_parts(state.cache_v),
                          kv_parts(sub.cache_k) + kv_parts(sub.cache_v)):
        cache.index_copy_(1, idx.to(cache.device), new)
    out.zero_().index_copy_(0, idx, out_w)
    n_new.zero_().index_copy_(0, idx, n_new_w)


def chunk(cfg: LLMConfig, w: dict, eog_ids: torch.Tensor, n_steps: int,
          sampler: SamplerParams | BatchSamplerParams, state: GenState, *,
          rem: torch.Tensor | None = None, lanes: torch.Tensor | None = None,
          warm_state=None) -> decode_graph.Chunk:
    """A chunk of ``n_steps`` decode steps on ``state``, which becomes the
    chunk's; ``run()`` runs them. The body follows from the arguments: a
    ``SamplerParams`` gives the CLI's step (``sample_chain_step``, the state's
    one key), a ``BatchSamplerParams`` the server's (``sample_step``, a key
    per lane), with ``rem`` [B] each lane's budget (None: none); ``lanes``
    [width] int64 makes it width-sliced (``_chunk_body_sliced``). The
    sampler's tensors, ``rem`` and ``lanes`` are read at every run, so a
    caller writes each dispatch's values into them first and one chunk
    serves any mix of requests. The sampler's seed is not baked in: it lives
    in the state's key.

    Where the state is on CUDA and ``w`` is not a tensor-parallel group over
    several cards (``spans_devices``), the chunk is captured as a CUDA graph
    here and every run is one replay; everywhere else a run is one eager
    call of the body on the same buffers. ``warm_state``: as in
    ``decode_graph.Chunk``."""
    if lanes is not None:
        def body(st, out, n_new):
            _chunk_body_sliced(cfg, w, eog_ids, n_steps, sampler, rem, lanes, st, out, n_new)
    else:
        step = sample_step if isinstance(sampler, BatchSamplerParams) else sample_chain_step

        def body(st, out, n_new):
            _chunk_body(cfg, w, eog_ids, n_steps, step, sampler, rem, st, out, n_new)

    capture = state.logits.device.type == "cuda" and not spans_devices(w)
    return decode_graph.Chunk(body, state, n_steps, capture=capture, warm_state=warm_state)


class ChunkFetch:
    """A chunk's host-visible results on their way to the host
    (miotts_tpu/models/llm.py ``start_chunk_fetch``): [n_new | done |
    tokens] packed on the device into one int32 [B, 2 + n_steps] tensor. On
    CUDA the pack, an asynchronous copy into pinned host memory and an event
    are queued on the current stream, so a chunk's ``out``/``n_new`` may be
    overwritten by the next run queued after them, and ``result`` waits for
    this chunk's event only."""

    def __init__(self, out: torch.Tensor, n_new: torch.Tensor, state: GenState):
        packed = torch.cat([n_new.to(torch.int32)[:, None],
                            state.done.to(torch.int32)[:, None], out.to(torch.int32)], dim=1)
        self.event = None
        if packed.device.type == "cuda":
            self.host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = packed.clone()

    def result(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Block for the copy; returns (out, n_new, done) as numpy arrays."""
        if self.event is not None:
            self.event.synchronize()
        packed = self.host.numpy()
        return packed[:, 2:], packed[:, 0], packed[:, 1].astype(bool)


# JAX's names for the two halves of a chunk's read
start_chunk_fetch = ChunkFetch
finish_chunk_fetch = ChunkFetch.result


def fetch_chunk_result(out: torch.Tensor, n_new: torch.Tensor, state: GenState
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A chunk's one device -> host copy, waited for: (out, n_new, done)."""
    return ChunkFetch(out, n_new, state).result()


def _chunks(ch: decode_graph.Chunk, state: GenState):
    """Runs of ``ch`` after ``state`` is loaded into it, each fetched as
    (tokens, n_new, done)."""
    ch.load(state)
    while True:
        out, n_new = ch.run()
        yield fetch_chunk_result(out, n_new, ch.state)


def llm_generate(cfg: LLMConfig, w: dict, prompt_tokens: torch.Tensor,
                 prompt_lengths: torch.Tensor, eog_ids: torch.Tensor,
                 key: torch.Tensor, n_predict: int, sampler: SamplerParams,
                 cache_k: torch.Tensor, cache_v: torch.Tensor,
                 kept: decode_graph.Chunk | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill + generation in chunks of CHUNK steps, reading ``done`` once
    a chunk. Returns (tokens [B, n_predict], n_generated [B]) on the host,
    as int64 tensors; a lane stops at its first EOG token, which is
    included. Done lanes emit 0s.

    The chunks are runs of ``kept``, a ``chunk`` of CHUNK steps with this
    sampler whose state holds ``cache_k``/``cache_v`` (the prefill writes
    there), which the caller keeps from request to request; None makes one
    on the prefilled state."""
    B = prompt_tokens.shape[0]
    state = llm_start(cfg, w, prompt_tokens, prompt_lengths, cache_k, cache_v, key)
    outs, total = [np.zeros((B, 0), np.int32)], np.zeros(B, np.int64)
    chunks = _chunks(kept or chunk(cfg, w, eog_ids, CHUNK, sampler, state), state)
    for _ in range(-(-n_predict // CHUNK)):
        out_np, n_np, done_np = next(chunks)
        outs.append(out_np)
        total += n_np
        if done_np.all():
            break
    tokens = np.concatenate(outs, axis=1)[:, :n_predict]
    tokens = np.pad(tokens, ((0, 0), (0, n_predict - tokens.shape[1])))
    return (torch.from_numpy(tokens.astype(np.int64)),
            torch.from_numpy(np.minimum(total, n_predict)))


# ---------------------------------------------------------------------------
# continuous batching: each lane of one state is its own request
# ---------------------------------------------------------------------------

def init_batched_state(cfg: LLMConfig, n_lanes: int, max_ctx: int, device: torch.device,
                       seed: int = 0, w=None) -> GenState:
    """A state of ``n_lanes`` lanes over a cache of ``max_ctx`` rows, every
    lane done (miotts_tpu/models/llm.py:1145); the key is per lane, [B, 2].
    ``w``: as in ``empty_gen_state``."""
    st = empty_gen_state(cfg, n_lanes, max_ctx, device, w=w)
    st.done.fill_(True)
    st.key = sampler_keys(np.arange(n_lanes) + seed, device)
    return st


def prefilled(logits: torch.Tensor, new_k, new_v, lengths: torch.Tensor, seeds) -> GenState:
    """The group state of k prefilled requests, ``llm_prefill_kv``'s
    result (logits [k, V], K/V [L, k, T, KVH, HD]) with pos = lengths [k]
    (a device tensor), an empty ring at cursor 0, not done and a fresh key
    from each seed."""
    k, dev = logits.shape[0], logits.device
    s0 = SamplerState.init(k, dev)
    return GenState(logits, new_k, new_v, lengths.to(torch.int32), s0.ring, s0.idx,
                    torch.zeros((k,), dtype=torch.bool, device=dev), sampler_keys(seeds, dev))


def attach_group(state: GenState, lanes, gst: GenState) -> GenState:
    """Install a group state's k lanes into lanes ``lanes`` of ``state`` IN
    PLACE (miotts_tpu/models/llm.py:620-640 ``attach_lanes_gen``): row i of
    ``gst`` (a ``prefilled`` group, or a fused group mid-generation) goes
    to lane ``lanes[i]``: its logits, cache rows [0, T) for the group's T
    rows, pos, ring, done and key. ``lanes`` is a host array; a row whose
    lane is out of range (a pad row) is dropped. Decode never reads past
    pos, and writes each row before pos reaches it. The batched state's
    ring cursor stays as it is."""
    B, S = state.pos.shape[0], kv_parts(state.cache_k)[0].shape[2]
    lanes = np.asarray(lanes).reshape(-1)
    rows = [i for i, lane in enumerate(lanes) if 0 <= int(lane) < B]
    if not rows:
        return state
    dev = state.pos.device
    r = to_device(np.asarray(rows, np.int64), dev)
    ln = to_device(lanes[rows].astype(np.int64), dev)
    T = min(kv_parts(gst.cache_k)[0].shape[2], S)
    state.logits.index_copy_(0, ln, gst.logits.index_select(0, r).to(state.logits.dtype))
    for cache, new in zip(kv_parts(state.cache_k) + kv_parts(state.cache_v),
                          kv_parts(gst.cache_k) + kv_parts(gst.cache_v)):
        cache.narrow(2, 0, T).index_copy_(
            1, ln.to(cache.device), new[:, :, :T].index_select(1, r.to(new.device)).to(cache.dtype))
    for name in ("pos", "ring", "done", "key"):
        getattr(state, name).index_copy_(0, ln, getattr(gst, name).index_select(0, r))
    return state


def attach_lanes(state: GenState, lanes, logits_k: torch.Tensor, new_k: torch.Tensor,
                 new_v: torch.Tensor, lengths, seeds) -> GenState:
    """Install k prefilled requests into lanes ``lanes`` of ``state`` IN
    PLACE (miotts_tpu/models/llm.py:1110): ``attach_group`` of their
    ``prefilled`` group, from host ``lengths`` and ``seeds``."""
    lengths = to_device(np.asarray(lengths, np.int32).reshape(-1), logits_k.device)
    return attach_group(state, lanes, prefilled(logits_k, new_k, new_v, lengths, seeds))


def set_lane_done(state: GenState, lane: int) -> GenState:
    """Mark lane ``lane`` done in place: it emits nothing and keeps its pos."""
    state.done[int(lane)] = True
    return state


# ---------------------------------------------------------------------------
# the fused submit path: prefill + a request's first steps, then an attach
# ---------------------------------------------------------------------------

NO_BUDGET = 1 << 30  # a ``rem`` no chunk reaches: the fused steps run unbudgeted, as JAX's


def prefill_into(cfg: LLMConfig, w: dict, tokens: torch.Tensor, lengths: torch.Tensor,
                 seeds, state: GenState) -> GenState:
    """Prefill a padded group [k, T] into the k lanes of ``state`` IN PLACE
    (the start of miotts_tpu/models/llm.py:579-617, JAX's fused prefill):
    logits of each last prompt token, the
    prompt's K/V at [0, T) (rows at t >= length carry garbage that decode
    never reads), pos = length, an empty ring at cursor 0, not done, and a
    fresh key from each seed."""
    T = tokens.shape[1]
    last, new_k, new_v = llm_prefill_kv(cfg, w, tokens, lengths)
    state.logits.copy_(last)
    for cache, new in zip(kv_parts(state.cache_k) + kv_parts(state.cache_v),
                          kv_parts(new_k) + kv_parts(new_v)):
        cache.narrow(2, 0, T).copy_(new)
    state.pos.copy_(lengths)
    state.ring.fill_(-1)
    state.ring_idx.zero_()
    state.done.zero_()
    state.key.copy_(sampler_keys(seeds, state.key.device))
    return state


def fused_state(cfg: LLMConfig, k: int, S: int, device: torch.device, w=None) -> GenState:
    """A k-lane state over S cache rows with per-lane keys: the buffers of a
    fused first chunk (``prefill_into``, then a chunk with no budget, whose
    first rows ``GenState.head`` hands to ``attach_group``, as JAX's fused
    prefill, miotts_tpu/models/llm.py:579-617); ``w`` as in
    ``empty_gen_state``."""
    st = empty_gen_state(cfg, k, S, device, w=w)
    st.key = sampler_keys(np.zeros(k, np.int64), device)
    return st


# ---------------------------------------------------------------------------
# engine (host-side orchestration)
# ---------------------------------------------------------------------------

CHAT_TEMPLATE = "<|im_start|>user\n{text}<|im_end|>\n<|im_start|>assistant\n"

_PROMPT_BUCKETS = (32, 64, 128, 256, 512)


class LLMEngine:
    """Load a MioTTS LLM GGUF and run text -> codec-token generation
    (generate_audio_tokens, tts-mio-cli.cpp:1002-1063)."""

    def __init__(self, path: str, device: torch.device, dtype: torch.dtype = torch.bfloat16,
                 quantize=None):
        # quantize: None defers to MIOTTS_LLM_QUANT (load_llm_gguf semantics);
        # the CLI passes --llm-quant
        self.device = device
        self.config, self.weights, self.tokenizer = load_llm_gguf(path, device, dtype,
                                                                  quantize=quantize)
        self.quantize = (quantize if quantize is not None
                         else os.environ.get("MIOTTS_LLM_QUANT", "")) or "bf16"
        self._init_vocab_maps()
        # the chunk generation runs on and the (cache rows, sampler) it serves
        self._chunk: decode_graph.Chunk | None = None
        self._chunk_key = None

    def _init_vocab_maps(self) -> None:
        pat = re.compile(r"^<\|s_(\d+)\|>$")
        self.token_to_code: dict[int, int] = {}
        for tid, text in enumerate(self.tokenizer.tokens):
            m = pat.match(text)
            if m and 0 <= int(m.group(1)) <= 12799:
                self.token_to_code[tid] = int(m.group(1))
        if not self.token_to_code:
            raise ValueError("MioTTS audio token range not found (<|s_0|>..<|s_12799|>)")
        eog = sorted(t for t in range(len(self.tokenizer.tokens)) if self.tokenizer.is_eog(t))
        self.eog_ids = torch.tensor(eog or [-1], dtype=torch.int64, device=self.device)

    def tokens_to_codes(self, tokens: list[int]) -> list[int]:
        return [self.token_to_code[t] for t in tokens if t in self.token_to_code]

    def token_to_code_or_none(self, token: int) -> int | None:
        return self.token_to_code.get(token)

    def _prompt(self, text: str, n_predict: int, n_ctx: int, sampler: SamplerParams):
        """Chat-templated prompt ids padded to their bucket, on the device,
        with its length, and the engine's chunk for a KV cache of max(n_ctx,
        T + n_predict + 32) rows and this sampler (its seed aside): the one
        it keeps, or a new one that replaces it. The prefill writes into the
        chunk's cache."""
        ids = self.tokenizer.encode(CHAT_TEMPLATE.format(text=text), parse_special=True)
        T = len(ids)
        bucket = next((b for b in _PROMPT_BUCKETS if T <= b), ((T + 127) // 128) * 128)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :T] = ids
        S = max(n_ctx, T + n_predict + 32)
        key = (S, dataclasses.replace(sampler, seed=0))
        if self._chunk_key != key:
            self._chunk = self._chunk_key = None  # its buffers go before the next ones
            self._chunk = chunk(self.config, self.weights, self.eog_ids, CHUNK, sampler,
                                empty_gen_state(self.config, 1, S, self.device, w=self.weights))
            self._chunk_key = key
        return (torch.from_numpy(toks).to(self.device),
                torch.tensor([T], dtype=torch.int32, device=self.device), self._chunk)

    def generate_audio_tokens(self, text: str, n_predict: int = 400, n_ctx: int = 700,
                              sampler: SamplerParams | None = None) -> list[int]:
        sampler = sampler or SamplerParams()
        toks, lengths, ch = self._prompt(text, n_predict, n_ctx, sampler)
        out, n_gen = llm_generate(self.config, self.weights, toks, lengths, self.eog_ids,
                                  sampler_key(sampler.seed, self.device), n_predict, sampler,
                                  ch.state.cache_k, ch.state.cache_v, ch)
        n = int(n_gen[0])
        return [int(t) for t in out[0, :n].tolist()]

    def generate_audio_tokens_streaming(self, text: str, on_token, n_predict: int = 700,
                                        n_ctx: int = 700,
                                        sampler: SamplerParams | None = None) -> list[int]:
        """Streaming variant (miotts_tpu/models/llm.py:1254-1300): generation
        runs in chunks of CHUNK steps, always whole chunks (one chunk's runs)
        truncated on the host; ``on_token(token_id, index, is_eog) -> bool``
        is called per token and may return False to cancel."""
        sampler = sampler or SamplerParams()
        toks, lengths, ch = self._prompt(text, n_predict, n_ctx, sampler)
        state = llm_start(self.config, self.weights, toks, lengths, ch.state.cache_k,
                          ch.state.cache_v, sampler_key(sampler.seed, self.device))
        generated: list[int] = []
        eog = set(self.eog_ids.tolist())
        chunks = _chunks(ch, state)
        while len(generated) < n_predict:
            out_np, n_np, done_np = next(chunks)
            n = int(n_np[0])
            for t in out_np[0][:n][: n_predict - len(generated)]:
                t = int(t)
                generated.append(t)
                if on_token is not None and not on_token(t, len(generated) - 1, t in eog):
                    return generated
            if n < CHUNK or bool(done_np[0]):
                break
        return generated
