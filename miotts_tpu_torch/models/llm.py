"""MioTTS codec-token LLM (llama/Qwen-family GGUF) in PyTorch
(miotts_tpu/models/llm.py).

Prefill is one batched forward; generation is a Python loop of decode
steps with the sampler chain between them (the JAX package runs the same
loop as one ``lax.while_loop``; a CUDA graph of the decode step is later
work). Norms are f32, logits f32. Matmul weights are dense bf16 (GGUF
Q8_0/f16/f32 tensors dequantized on the host and cast) or, by the
``--llm-quant`` ladder, kept quantized on the device (``load_llm_gguf``):
Q8_0 leaves run on kernel K3 (``ops/cuda/q8_matmul.py``), W8A8 and W4A8
leaves on exact int8 dots (``ops/quant_matmul.py``).

The decode step keeps the JAX operand contract: attention reads the cache
STRICTLY below ``pos`` and takes the current token's k/v as operands, and
the step scatters one [L, B] row pair into the cache after the layer stack.
The port updates the KV cache IN PLACE (prefill and decode step), where
JAX returns new caches. On CUDA the decode attention is kernel K2
(``ops/cuda/decode_attention.py``). Prefill attention is plain torch, as
JAX computes it outside any kernel.

The dense logits head accumulates bf16 x bf16 straight into f32 logits, as
XLA's ``preferred_element_type=f32`` does. A quantized head rounds its
logits to the activation dtype before the f32 cast, as JAX's
``_mm(...).astype(x.dtype)`` does.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf import GGUFReader
from ..ops.cuda.decode_attention import decode_attention
from ..ops.quant_matmul import (
    maybe_quant_matmul as _mm, quantize_int4_percol, quantize_int8_percol, quantize_q8_cols)
from ..ops.rope import apply_rope
from ..runtime.tokenizer import BPETokenizer
from .sampling import SamplerParams, SamplerState, sample_token


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


def load_llm_gguf(path: str, device: torch.device, dtype: torch.dtype = torch.bfloat16,
                  quantize=None) -> tuple[LLMConfig, dict, BPETokenizer]:
    """Every tensor is dequantized to f32 on the host and matmul weights are
    transposed to [in, out] with q|k|v and gate|up fused column-wise. By
    ``quantize`` (``_quant_modes``) the matmul leaves and the head are then
    quantized on the host as the JAX loader does them (``quantize_kn``, the
    head from its [D, V] transpose); dense leaves are cast to ``dtype``. A
    dense logits head stays [V, D] (None when tied to the embedding)."""
    mode = _quant_modes(quantize)
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

        def t(name, transpose=False):
            arr = r.tensor(name, dtype=np.float32)
            return np.ascontiguousarray(arr.T) if transpose else arr

        def stack_layers(per_layer, quant):
            if not (quant and mode["layers"]):
                return np.stack(per_layer)
            leaves = [quantize_kn(a, mode["layer_kind"]) for a in per_layer]
            return {k: np.stack([leaf[k] for leaf in leaves]) for k in leaves[0]}

        def stack(fmt, transpose=False, quant=False):
            return stack_layers([t(fmt.format(i=i), transpose) for i in range(n_layers)], quant)

        def stack_fused(fmts):
            return stack_layers([np.concatenate([t(f.format(i=i), True) for f in fmts], axis=1)
                                 for i in range(n_layers)], quant=True)

        if cfg.tie_embeddings:
            head = _warn_tied_quant_noop(mode["head"], mode["requested"])
        elif mode["head"]:
            head = quantize_kn(t("output.weight", transpose=True), mode["head_kind"])
        else:
            head = t("output.weight")
        w = {
            "token_embd": t("token_embd.weight"),
            "attn_norm": stack("blk.{i}.attn_norm.weight"),
            "wqkv": stack_fused(["blk.{i}.attn_q.weight", "blk.{i}.attn_k.weight",
                                 "blk.{i}.attn_v.weight"]),
            "bqkv": (np.stack([np.concatenate([t(f"blk.{i}.attn_{p}.bias") for p in "qkv"])
                               for i in range(n_layers)]) if cfg.has_qkv_bias else None),
            "wo": stack("blk.{i}.attn_output.weight", transpose=True, quant=True),
            "ffn_norm": stack("blk.{i}.ffn_norm.weight"),
            "w_gateup": stack_fused(["blk.{i}.ffn_gate.weight", "blk.{i}.ffn_up.weight"]),
            "w_down": stack("blk.{i}.ffn_down.weight", transpose=True, quant=True),
            "q_norm": stack("blk.{i}.attn_q_norm.weight") if cfg.has_qk_norm else None,
            "k_norm": stack("blk.{i}.attn_k_norm.weight") if cfg.has_qk_norm else None,
            "output_norm": t("output_norm.weight"),
            "output": head,
        }
    return cfg, weights_to_device(w, device, dtype), tokenizer


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * weight).to(x.dtype)


def _dense_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x [N, D] against a dense [V, D] head -> f32 [N, V], accumulated
    straight into f32. On CUDA one cuBLAS call writes f32 from bf16
    operands; the CPU build has no such matmul, so it multiplies the bf16
    values as f32, which gives the same exact products."""
    if x.dtype == torch.float32 and head.dtype == torch.float32:
        return x @ head.t()
    if x.device.type == "cuda":
        return torch.mm(x, head.t(), out_dtype=torch.float32)
    return x.float() @ head.float().t()


def _logits(cfg: LLMConfig, w: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, D] -> f32 logits [B, V]. A dense head is [V, D] (or the tied
    embedding); a quantized head is a [D, V]-derived leaf whose padded
    columns are sliced off."""
    head = w["output"] if w["output"] is not None else w["token_embd"]
    if isinstance(head, dict):
        return _mm(x, head).float()[..., :cfg.vocab_size]
    return _dense_logits(x, head)


_BLK_KEYS = ("attn_norm", "wqkv", "bqkv", "wo", "ffn_norm", "w_gateup", "w_down",
             "q_norm", "k_norm")


def _layer(w: dict, li: int) -> dict:
    """Layer ``li``'s slice of the stacked per-layer leaves."""
    def pick(v):
        if v is None:
            return None
        return {k: a[li] for k, a in v.items()} if isinstance(v, dict) else v[li]
    return {k: pick(w[k]) for k in _BLK_KEYS}


def _layer_qkv(cfg: LLMConfig, blk: dict, xn: torch.Tensor):
    Hd = cfg.n_heads * cfg.head_dim
    KVd = cfg.n_kv_heads * cfg.head_dim
    # quantized leaves are padded along N: slice before the bias add
    qkv = _mm(xn, blk["wqkv"])[..., :Hd + 2 * KVd]
    if blk["bqkv"] is not None:
        qkv = qkv + blk["bqkv"]
    B, T = xn.shape[:2]
    q = qkv[..., :Hd].reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = qkv[..., Hd:Hd + KVd].reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = qkv[..., Hd + KVd:].reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    if blk["q_norm"] is not None:
        q = rms_norm(q, blk["q_norm"], cfg.rms_eps)
        k = rms_norm(k, blk["k_norm"], cfg.rms_eps)
    return q, k, v


def _layer_ffn(cfg: LLMConfig, blk: dict, x: torch.Tensor) -> torch.Tensor:
    fn = rms_norm(x, blk["ffn_norm"], cfg.rms_eps)
    gu = _mm(fn, blk["w_gateup"])
    act = F.silu(gu[..., :cfg.ffn_dim]) * gu[..., cfg.ffn_dim:2 * cfg.ffn_dim]
    return _mm(act, blk["w_down"])[..., :cfg.dim]


def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int, device: torch.device,
                  dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
    """[L, B, S, KVH, HD] zeros; bf16 whatever the weights' dtype, as JAX."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def llm_prefill_kv(cfg: LLMConfig, w: dict, tokens: torch.Tensor, lengths: torch.Tensor):
    """Padded prompts [B, T] at positions 0..T-1 -> (last-valid-token logits
    [B, V] f32, prompt K [L, B, T, KVH, HD], prompt V). Rows at
    t >= lengths[b] carry garbage K/V that decode never reads (it masks keys
    at positions >= pos)."""
    B, T = tokens.shape
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)
    x = w["token_embd"][tokens.long()]
    group = cfg.n_heads // cfg.n_kv_heads
    t_idx = torch.arange(T, device=dev)
    causal = t_idx[:, None] >= t_idx[None, :]
    valid_k = t_idx[None, :] < lengths[:, None]
    mask = (causal[None] & valid_k[:, None, :])[:, None]  # [B, 1, Tq, Tk]
    scale = 1.0 / math.sqrt(cfg.head_dim)

    new_k, new_v = [], []
    for li in range(cfg.n_layers):
        blk = _layer(w, li)
        q, k, v = _layer_qkv(cfg, blk, rms_norm(x, blk["attn_norm"], cfg.rms_eps))
        q = apply_rope(q, positions, cfg.rope_base, cfg.rope_neox)
        k = apply_rope(k, positions, cfg.rope_base, cfg.rope_neox)
        new_k.append(k)
        new_v.append(v)
        kr = k.repeat_interleave(group, dim=2)
        vr = v.repeat_interleave(group, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1).to(x.dtype)
        att = torch.einsum("bhqk,bkhd->bqhd", probs, vr).reshape(B, T, -1)
        x = x + _mm(att, blk["wo"])[..., :cfg.dim]
        x = x + _layer_ffn(cfg, blk, x)

    xn = rms_norm(x, w["output_norm"], cfg.rms_eps)
    last = torch.clamp(lengths.long() - 1, min=0)
    xn_last = xn[torch.arange(B, device=dev), last]  # [B, D]
    return _logits(cfg, w, xn_last), torch.stack(new_k), torch.stack(new_v)


def llm_prefill(cfg: LLMConfig, w: dict, tokens: torch.Tensor, lengths: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor) -> torch.Tensor:
    """Prefill and write K/V at [0, length) of each lane's cache IN PLACE
    (writes past the cache end are dropped). Returns the last valid
    token's logits [B, V]."""
    S = cache_k.shape[2]
    last, new_k, new_v = llm_prefill_kv(cfg, w, tokens, lengths)
    for b, n in enumerate(lengths.tolist()):
        n = max(0, min(int(n), S))
        cache_k[:, b, :n] = new_k[:, b, :n].to(cache_k.dtype)
        cache_v[:, b, :n] = new_v[:, b, :n].to(cache_v.dtype)
    return last


def llm_decode_step(cfg: LLMConfig, w: dict, token: torch.Tensor, pos: torch.Tensor,
                    cache_k: torch.Tensor, cache_v: torch.Tensor) -> torch.Tensor:
    """One decode step for lanes token/pos [B] (pos int32). Returns logits
    [B, V] f32; this step's k/v land in the cache at ``pos`` IN PLACE (a
    pos past the cache end writes nothing)."""
    B = token.shape[0]
    S = cache_k.shape[2]
    group = cfg.n_heads // cfg.n_kv_heads
    x = w["token_embd"][token.long()][:, None, :]  # [B, 1, D]
    positions = pos[:, None]
    scale = 1.0 / math.sqrt(cfg.head_dim)

    new_ks, new_vs = [], []
    for li in range(cfg.n_layers):
        blk = _layer(w, li)
        q, k, v = _layer_qkv(cfg, blk, rms_norm(x, blk["attn_norm"], cfg.rms_eps))
        q = apply_rope(q, positions, cfg.rope_base, cfg.rope_neox)
        k = apply_rope(k, positions, cfg.rope_base, cfg.rope_neox)
        # rounded to the cache dtype first: attention sees exactly the
        # values the scatter stores
        k1 = k[:, 0].to(cache_k.dtype).contiguous()
        v1 = v[:, 0].to(cache_v.dtype).contiguous()
        new_ks.append(k1)
        new_vs.append(v1)
        qh = q[:, 0].reshape(B, cfg.n_kv_heads, group, cfg.head_dim).contiguous()
        att = decode_attention(qh, k1, v1, cache_k[li], cache_v[li], scale, pos).to(x.dtype)
        x = x + _mm(att[:, None, :], blk["wo"])[..., :cfg.dim]
        x = x + _layer_ffn(cfg, blk, x)

    b_idx = torch.arange(B, device=token.device)
    in_range = (pos < S)[None, :, None, None]
    p = torch.clamp(pos.long(), max=S - 1)
    for cache, new in ((cache_k, torch.stack(new_ks)), (cache_v, torch.stack(new_vs))):
        cache[:, b_idx, p] = torch.where(in_range, new, cache[:, b_idx, p])

    xn = rms_norm(x, w["output_norm"], cfg.rms_eps)
    return _logits(cfg, w, xn[:, 0])


def llm_generate(cfg: LLMConfig, w: dict, prompt_tokens: torch.Tensor,
                 prompt_lengths: torch.Tensor, eog_ids: torch.Tensor,
                 generator: torch.Generator, n_predict: int, sampler: SamplerParams,
                 cache_k: torch.Tensor, cache_v: torch.Tensor):
    """Prefill + autoregressive generation. Returns (tokens [B, n_predict],
    n_generated [B]); a lane stops at its first EOG token, which is
    included. Done lanes emit 0s."""
    B = prompt_tokens.shape[0]
    dev = prompt_tokens.device
    logits = llm_prefill(cfg, w, prompt_tokens, prompt_lengths, cache_k, cache_v)
    out = torch.zeros((B, n_predict), dtype=torch.int64, device=dev)
    n_gen = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    pos = prompt_lengths.to(torch.int32).clone()
    state = SamplerState.init(B, dev)
    for i in range(n_predict):
        tok = sample_token(logits, sampler, state, generator)
        state.update(tok)
        out[:, i] = torch.where(done, torch.zeros_like(tok), tok)
        n_gen += (~done).to(torch.int32)
        done = done | torch.isin(tok, eog_ids)
        # the step after the last sample would only feed a finished loop
        if i + 1 == n_predict or bool(done.all()):
            break
        logits = llm_decode_step(cfg, w, tok, pos, cache_k, cache_v)
        pos = pos + (~done).to(torch.int32)
    return out, n_gen


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

    def generate_audio_tokens(self, text: str, n_predict: int = 400, n_ctx: int = 700,
                              sampler: SamplerParams | None = None) -> list[int]:
        sampler = sampler or SamplerParams()
        ids = self.tokenizer.encode(CHAT_TEMPLATE.format(text=text), parse_special=True)
        T = len(ids)
        bucket = next((b for b in _PROMPT_BUCKETS if T <= b), ((T + 127) // 128) * 128)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :T] = ids
        cache_k, cache_v = init_kv_cache(self.config, 1, max(n_ctx, T + n_predict + 32),
                                         self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sampler.seed)
        out, n_gen = llm_generate(
            self.config, self.weights, torch.from_numpy(toks).to(self.device),
            torch.tensor([T], dtype=torch.int32, device=self.device), self.eog_ids, gen,
            n_predict, sampler, cache_k, cache_v)
        n = int(n_gen[0])
        return [int(t) for t in out[0, :n].tolist()]
