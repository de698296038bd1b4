"""Native int8/int4 CPU LLM engine (miotts_tpu/models/llm_cpu.py): local
text -> codec tokens on a CPU-only host.

The matmul weights stay GGUF Q8_0/Q4_0 blocks and run on the port's copy of
the JAX package's block-quant GEMVs (``runtime/native.py``,
``runtime/native/miotts_runtime.cpp``: activations quantized per 32-block to
int8, one int32 dot a block, rows over a persistent thread pool); RMSNorm,
RoPE, attention and the sampler are numpy. Weight traffic is ~1.06 bytes a
parameter a token at Q8_0 and ~0.56 at Q4_0, so the bandwidth-bound decode
runs faster at Q4_0 (MIOTTS_CPU_QUANT=q4_0 requantizes any GGUF to it;
q8_0 to Q8_0; auto, the default, runs Q8_0/Q4_0 payloads as they are and
quantizes anything else to Q8_0).

The engine has ``LLMEngine``'s generation API
(``generate_audio_tokens[_streaming]``, ``tokens_to_codes``), so the CLI
(``--cpu-native``, MIOTTS_CPU_NATIVE) and ``MioTTSEngine`` pick it on a CPU
device. It is numpy and the copied C++, no torch tensor in its compute, and
its sampler draws from numpy's ``default_rng(seed)``: with the same GGUF and
seed it gives the JAX engine's tokens exactly, sampled runs included.
Activations are quantized as llama.cpp's Q8_0 are, so its outputs are
llama.cpp-class, not the bf16 path's bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..gguf import GGUFReader
from ..gguf.quants import GGMLType, dequantize
from ..runtime.native import (
    Q4Gemv, Q8Gemv, q4_available, q4_quantize_weights, q4_row_dequant, q8_available,
    q8_quantize_weights, q8_row_dequant, unavailable_reason)
from ..runtime.tokenizer import BPETokenizer
from .llm import CHAT_TEMPLATE, LLMEngine
from .sampling import PENALTY_LAST_N, SamplerParams


def gguf_llm_cpu_native_ok(path: str) -> bool:
    """True when the GGUF's matmul weights (judged by
    ``blk.0.attn_q.weight``) are Q8_0 blocks (the shipped MioTTS-0.1B-Q8_0
    format) or Q4_0 (a llama.cpp 4-bit export): the engine then loads them
    without a quantization pass, and ``--cpu-native auto`` picks it. False
    for any file that cannot be read."""
    try:
        r = GGUFReader(path)
    except Exception:
        return False
    try:
        info = r.tensors.get("blk.0.attn_q.weight")
        return info is not None and info.ggml_type in (GGMLType.Q8_0, GGMLType.Q4_0)
    finally:
        r.close()


# back-compat alias (pre-Q4 name)
gguf_llm_is_q8 = gguf_llm_cpu_native_ok


def _softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=-1, keepdims=True)


class _Layer:
    __slots__ = ("attn_norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
                 "q_norm", "k_norm", "ffn_norm", "w_gate", "w_up", "w_down")


class NativeCpuLLMEngine(LLMEngine):
    """Drop-in for LLMEngine on CPU-only hosts (generation API subset)."""

    def __init__(self, path: str, n_threads: int = 0):
        # LLMEngine.__init__ is not called: this engine loads its own weights
        if not q8_available():
            raise RuntimeError(f"native q8 runtime unavailable ({unavailable_reason()})")
        self.device = torch.device("cpu")
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        r = GGUFReader(path)
        arch = r.get_str("general.architecture")

        def kv(key, default=None):
            return r.kv.get(f"{arch}.{key}", default)

        self.arch = arch
        self.n_layers = int(kv("block_count"))
        self.dim = int(kv("embedding_length"))
        self.n_heads = int(kv("attention.head_count"))
        self.n_kv = int(kv("attention.head_count_kv", self.n_heads))
        self.head_dim = int(kv("attention.key_length",
                               self.dim // self.n_heads))
        self.ffn = int(kv("feed_forward_length"))
        self.rms_eps = float(kv("attention.layer_norm_rms_epsilon", 1e-6))
        self.rope_base = float(kv("rope.freq_base", 10000.0))
        self.rope_neox = arch not in ("llama",)
        self.tokenizer = BPETokenizer.from_gguf_kv(r.kv)
        self.vocab_size = len(self.tokenizer.tokens)
        # MIOTTS_CPU_QUANT: auto (default) runs each block payload on its
        # native kernel (Q8_0/Q4_0 pass through; f32/f16 quantize to q8_0);
        # q4_0 / q8_0 force-requantize everything to that width. q4_0 halves
        # weight traffic (the bandwidth-bound gemv runs ~2x tokens/s) at
        # llama.cpp-Q4_0 quality — the same trade the reference exposes by
        # shipping llama.cpp, which serves any quant the GGUF carries.
        force = os.environ.get("MIOTTS_CPU_QUANT", "auto").lower()
        if force in ("", "auto"):
            force = None
        elif force not in ("q4_0", "q8_0"):
            raise ValueError(f"MIOTTS_CPU_QUANT={force!r} "
                             "(want auto|q4_0|q8_0)")
        if force == "q4_0" and not q4_available():
            raise RuntimeError(f"native q4 runtime unavailable ({unavailable_reason()})")
        self._kinds: set[str] = set()

        def mm(name):
            """Matmul weight [N, K] as raw quant block bytes (native layout:
            GGUF rows are K-contiguous). Q8_0/Q4_0 payloads pass through
            untouched; anything else dequantizes then requantizes to the
            forced width (default q8_0)."""
            info = r.tensors[name]
            n, k = info.shape  # torch convention [out, in]
            gt = info.ggml_type
            if gt == GGMLType.Q8_0 and force in (None, "q8_0"):
                self._kinds.add("q8_0")
                return Q8Gemv(r.tensor_raw(name).view(np.uint8).copy(), n, k)
            if gt == GGMLType.Q4_0 and force in (None, "q4_0") \
                    and q4_available():
                self._kinds.add("q4_0")
                return Q4Gemv(r.tensor_raw(name).view(np.uint8).copy(), n, k)
            flat = dequantize(r.tensor_raw(name), gt, info.n_elements)
            w = np.ascontiguousarray(flat.reshape(n, k))
            if force == "q4_0":
                self._kinds.add("q4_0")
                return Q4Gemv(q4_quantize_weights(w), n, k)
            self._kinds.add("q8_0")
            return Q8Gemv(q8_quantize_weights(w), n, k)

        def f32(name, optional=False):
            if optional and not r.has_tensor(name):
                return None
            return r.tensor(name, dtype=np.float32).astype(np.float32)

        self.layers: list[_Layer] = []
        for i in range(self.n_layers):
            L = _Layer()
            L.attn_norm = f32(f"blk.{i}.attn_norm.weight")
            L.wq = mm(f"blk.{i}.attn_q.weight")
            L.wk = mm(f"blk.{i}.attn_k.weight")
            L.wv = mm(f"blk.{i}.attn_v.weight")
            L.wo = mm(f"blk.{i}.attn_output.weight")
            L.bq = f32(f"blk.{i}.attn_q.bias", optional=True)
            L.bk = f32(f"blk.{i}.attn_k.bias", optional=True)
            L.bv = f32(f"blk.{i}.attn_v.bias", optional=True)
            L.q_norm = f32(f"blk.{i}.attn_q_norm.weight", optional=True)
            L.k_norm = f32(f"blk.{i}.attn_k_norm.weight", optional=True)
            L.ffn_norm = f32(f"blk.{i}.ffn_norm.weight")
            L.w_gate = mm(f"blk.{i}.ffn_gate.weight")
            L.w_up = mm(f"blk.{i}.ffn_up.weight")
            L.w_down = mm(f"blk.{i}.ffn_down.weight")
            self.layers.append(L)
        self.output_norm = f32("output_norm.weight")
        self.tie = not r.has_tensor("output.weight")
        self.output = None if self.tie else mm("output.weight")
        # embedding rows dequantize on demand (the [V, D] table is the
        # biggest tensor; only one row is read per token)
        einfo = r.tensors["token_embd.weight"]
        self._embd_kind = "q8_0"
        if einfo.ggml_type == GGMLType.Q8_0 and force in (None, "q8_0"):
            self._embd_raw = r.tensor_raw("token_embd.weight").view(
                np.uint8).copy()  # detach mmap
            self._embd_f32 = None
        elif einfo.ggml_type == GGMLType.Q4_0 and force in (None, "q4_0") \
                and q4_available():
            self._embd_raw = r.tensor_raw("token_embd.weight").view(
                np.uint8).copy()  # detach mmap
            self._embd_f32 = None
            self._embd_kind = "q4_0"
        else:
            flat = dequantize(r.tensor_raw("token_embd.weight"),
                              einfo.ggml_type, einfo.n_elements)
            self._embd_f32 = flat.reshape(einfo.shape).astype(np.float32)
            if not self.tie:
                self._embd_raw = None
            elif force == "q4_0":
                self._embd_raw = q4_quantize_weights(self._embd_f32)
                self._embd_kind = "q4_0"
            else:
                self._embd_raw = q8_quantize_weights(self._embd_f32)
            del flat  # drop the mmap view so close() can release the map
        if self.tie:
            tied_gemv = Q4Gemv if self._embd_kind == "q4_0" else Q8Gemv
            self.output = tied_gemv(self._embd_raw, self.vocab_size, self.dim)
            self._kinds.add(self._embd_kind)
        self.quantize = ("mixed-cpu" if len(self._kinds) > 1
                         else f"{next(iter(self._kinds))}-cpu")
        r.close()

        # RoPE tables filled lazily per max position
        self._rope_tab = (np.zeros((0, self.head_dim // 2), np.float32),
                          np.zeros((0, self.head_dim // 2), np.float32))
        self._init_vocab_maps()
        self.eog_set = {int(t) for t in self.eog_ids.tolist()}

    # -- small numpy ops -----------------------------------------------------

    def _embd_row(self, token: int) -> np.ndarray:
        if self._embd_f32 is not None:
            return self._embd_f32[token].copy()
        if self._embd_kind == "q4_0":
            return q4_row_dequant(self._embd_raw, token, self.dim)
        return q8_row_dequant(self._embd_raw, token, self.dim)

    def _rms(self, x: np.ndarray, w: np.ndarray) -> np.ndarray:
        return x * (1.0 / np.sqrt(np.mean(x * x) + self.rms_eps)) * w

    def _rope_tables(self, upto: int):
        # concurrency: read/publish ONE tuple attribute (a cos/sin pair
        # published as two stores could be observed torn — long cos, short
        # sin) and return the locals, never re-read the attribute
        cos, sin = self._rope_tab
        if cos.shape[0] < upto:
            half = self.head_dim // 2
            inv = self.rope_base ** (np.arange(half) * (-2.0 / self.head_dim))
            ang = np.arange(upto)[:, None] * inv[None, :]
            cos = np.cos(ang).astype(np.float32)
            sin = np.sin(ang).astype(np.float32)
            self._rope_tab = (cos, sin)
        return cos, sin

    def _rope(self, x: np.ndarray, pos: int) -> np.ndarray:
        """x: [H, D] -> rotated (NEOX half-split for qwen-family)."""
        cos, sin = self._rope_tables(pos + 1)
        c, s = cos[pos], sin[pos]
        half = self.head_dim // 2
        if self.rope_neox:
            x0, x1 = x[:, :half], x[:, half:]
            return np.concatenate([x0 * c - x1 * s, x0 * s + x1 * c], axis=1)
        xp = x.reshape(x.shape[0], half, 2)
        y0 = xp[:, :, 0] * c - xp[:, :, 1] * s
        y1 = xp[:, :, 0] * s + xp[:, :, 1] * c
        return np.stack([y0, y1], axis=2).reshape(x.shape)

    # -- decode step ----------------------------------------------------------

    def _step(self, token: int, pos: int, kc: np.ndarray, vc: np.ndarray
              ) -> np.ndarray:
        """One token through all layers. kc/vc: [L, S, KV, HD] caches
        (written at `pos`). Returns f32 logits [V]."""
        H, KV, HD = self.n_heads, self.n_kv, self.head_dim
        nt = self.n_threads
        x = self._embd_row(token)
        for li, L in enumerate(self.layers):
            h = self._rms(x, L.attn_norm)
            q = L.wq(h, n_threads=nt)
            k = L.wk(h, n_threads=nt)
            v = L.wv(h, n_threads=nt)
            if L.bq is not None:
                q += L.bq
                k += L.bk
                v += L.bv
            q = q.reshape(H, HD)
            k = k.reshape(KV, HD)
            if L.q_norm is not None:
                q = q * (1.0 / np.sqrt(
                    np.mean(q * q, axis=1, keepdims=True) + self.rms_eps)
                ) * L.q_norm
                k = k * (1.0 / np.sqrt(
                    np.mean(k * k, axis=1, keepdims=True) + self.rms_eps)
                ) * L.k_norm
            q = self._rope(q, pos)
            k = self._rope(k, pos)
            kc[li, pos] = k
            vc[li, pos] = v.reshape(KV, HD)
            # GQA attention over the cache so far
            keys = kc[li, :pos + 1]  # [S, KV, HD]
            vals = vc[li, :pos + 1]
            group = H // KV
            qg = q.reshape(KV, group, HD)
            scores = np.einsum("kgd,skd->kgs", qg, keys) / np.sqrt(HD)
            probs = _softmax(scores)
            ctx = np.einsum("kgs,skd->kgd", probs, vals).reshape(H * HD)
            x = x + L.wo(ctx.astype(np.float32), n_threads=nt)
            h = self._rms(x, L.ffn_norm)
            gate = L.w_gate(h, n_threads=nt)
            up = L.w_up(h, n_threads=nt)
            act = gate / (1.0 + np.exp(-gate)) * up  # silu(gate) * up
            x = x + L.w_down(act.astype(np.float32), n_threads=nt)
        h = self._rms(x, self.output_norm)
        return self.output(h, n_threads=nt)

    # -- batched prompt prefill -------------------------------------------------

    PREFILL_BLOCK = 16

    def _rope_block(self, x: np.ndarray, pos0: int) -> np.ndarray:
        """x: [B, H, D] rotated at absolute positions pos0..pos0+B-1."""
        B = x.shape[0]
        cos, sin = self._rope_tables(pos0 + B)
        c = cos[pos0:pos0 + B][:, None, :]
        s = sin[pos0:pos0 + B][:, None, :]
        half = self.head_dim // 2
        if self.rope_neox:
            x0, x1 = x[:, :, :half], x[:, :, half:]
            return np.concatenate([x0 * c - x1 * s, x0 * s + x1 * c], axis=2)
        xp = x.reshape(B, x.shape[1], half, 2)
        y0 = xp[:, :, :, 0] * c - xp[:, :, :, 1] * s
        y1 = xp[:, :, :, 0] * s + xp[:, :, :, 1] * c
        return np.stack([y0, y1], axis=3).reshape(x.shape)

    def _prefill_block(self, tokens: list[int], pos0: int, kc: np.ndarray,
                       vc: np.ndarray) -> np.ndarray:
        """B prompt tokens through all layers in ONE weight pass per matmul
        (gemm: each weight row read once for all B rows — per-prompt-token
        weight traffic drops ~B-fold vs the token-by-token _step, which is
        what llama.cpp's batched prompt eval buys; tts-mio-cli.cpp prompt
        decode goes through the same llama.cpp path). Fills kc/vc at
        pos0..pos0+B-1 and returns the LAST token's f32 logits [V]."""
        H, KV, HD = self.n_heads, self.n_kv, self.head_dim
        nt = self.n_threads
        B = len(tokens)
        eps = self.rms_eps
        x = np.stack([self._embd_row(int(t)) for t in tokens])  # [B, D]
        # causal mask vs absolute key positions 0..pos0+B-1
        kpos = np.arange(pos0 + B)
        qpos = pos0 + np.arange(B)
        causal = kpos[None, :] <= qpos[:, None]  # [B, S]
        for li, L in enumerate(self.layers):
            h = x * (1.0 / np.sqrt(
                np.mean(x * x, axis=1, keepdims=True) + eps)) * L.attn_norm
            q = L.wq.gemm(h, n_threads=nt)
            k = L.wk.gemm(h, n_threads=nt)
            v = L.wv.gemm(h, n_threads=nt)
            if L.bq is not None:
                q += L.bq
                k += L.bk
                v += L.bv
            q = q.reshape(B, H, HD)
            k = k.reshape(B, KV, HD)
            if L.q_norm is not None:
                q = q * (1.0 / np.sqrt(
                    np.mean(q * q, axis=2, keepdims=True) + eps)) * L.q_norm
                k = k * (1.0 / np.sqrt(
                    np.mean(k * k, axis=2, keepdims=True) + eps)) * L.k_norm
            q = self._rope_block(q, pos0)
            k = self._rope_block(k, pos0)
            kc[li, pos0:pos0 + B] = k
            vc[li, pos0:pos0 + B] = v.reshape(B, KV, HD)
            keys = kc[li, :pos0 + B]  # [S, KV, HD]
            vals = vc[li, :pos0 + B]
            group = H // KV
            qg = q.reshape(B, KV, group, HD)
            scores = np.einsum("bkgd,skd->bkgs", qg, keys) / np.sqrt(HD)
            scores = np.where(causal[:, None, None, :], scores, -np.inf)
            probs = _softmax(scores)
            ctx = np.einsum("bkgs,skd->bkgd", probs, vals).reshape(B, H * HD)
            x = x + L.wo.gemm(ctx.astype(np.float32), n_threads=nt)
            h = x * (1.0 / np.sqrt(
                np.mean(x * x, axis=1, keepdims=True) + eps)) * L.ffn_norm
            gate = L.w_gate.gemm(h, n_threads=nt)
            up = L.w_up.gemm(h, n_threads=nt)
            act = gate / (1.0 + np.exp(-gate)) * up
            x = x + L.w_down.gemm(act.astype(np.float32), n_threads=nt)
        h = self._rms(x[-1], self.output_norm)
        # only the LAST token's logits are sampled — one head gemv per
        # prompt instead of one per prompt token (the head is the single
        # biggest weight tensor)
        return self.output(h, n_threads=nt)

    def _prefill(self, ids, kc: np.ndarray, vc: np.ndarray) -> np.ndarray:
        """Prompt ids through blocked prefill; returns final logits."""
        logits = None
        pos = 0
        while pos < len(ids):
            block = [int(t) for t in ids[pos:pos + self.PREFILL_BLOCK]]
            logits = self._prefill_block(block, pos, kc, vc)
            pos += len(block)
        return logits

    # -- sampling (numpy mirror of sampling.sample_token) ---------------------

    def _sample(self, logits: np.ndarray, sampler: SamplerParams,
                ring: list[int], rng: np.random.Generator) -> int:
        if sampler.repeat_penalty != 1.0 and ring:
            ids = np.asarray(sorted(set(ring)), np.int64)
            pen = sampler.repeat_penalty
            lv = logits[ids]
            logits[ids] = np.where(lv > 0, lv / pen, lv * pen)
        if sampler.top_k > 0:
            k = min(sampler.top_k, logits.size)
            idx = np.argpartition(logits, -k)[-k:]
            idx = idx[np.argsort(-logits[idx])]
            vals = logits[idx]
        else:
            idx = np.argsort(-logits)
            vals = logits[idx]
        if 0.0 < sampler.top_p < 1.0:
            probs = _softmax(vals)
            cum = np.cumsum(probs)
            keep = (cum - probs) < sampler.top_p
            keep[0] = True
            vals = np.where(keep, vals, -np.inf)
        if sampler.temp <= 0.0:
            choice = int(np.argmax(vals))
        else:
            p = _softmax(vals / sampler.temp)
            choice = int(rng.choice(p.size, p=p))
        return int(idx[choice])

    # -- generation API (LLMEngine subset) ------------------------------------

    def generate_audio_tokens_streaming(self, text: str, on_token,
                                        n_predict: int = 700,
                                        n_ctx: int = 700,
                                        sampler: SamplerParams | None = None,
                                        chunk: int = 16) -> list[int]:
        sampler = sampler or SamplerParams()
        prompt = CHAT_TEMPLATE.format(text=text)
        ids = self.tokenizer.encode(prompt, parse_special=True)
        S = max(n_ctx, len(ids) + n_predict + 8)
        kc = np.zeros((self.n_layers, S, self.n_kv, self.head_dim), np.float32)
        vc = np.zeros_like(kc)
        rng = np.random.default_rng(sampler.seed)
        logits = self._prefill(ids, kc, vc)
        out: list[int] = []
        ring: list[int] = []
        pos = len(ids)
        for i in range(n_predict):
            tok = self._sample(logits.copy(), sampler, ring, rng)
            ring.append(tok)
            if len(ring) > PENALTY_LAST_N:
                ring.pop(0)
            is_eog = tok in self.eog_set
            out.append(tok)
            if on_token is not None and not on_token(tok, i, is_eog):
                break
            if is_eog or pos >= S - 1:
                break
            logits = self._step(tok, pos, kc, vc)
            pos += 1
        return out

    def generate_audio_tokens(self, text: str, n_predict: int = 400,
                              n_ctx: int = 700,
                              sampler: SamplerParams | None = None
                              ) -> list[int]:
        return self.generate_audio_tokens_streaming(
            text, None, n_predict=n_predict, n_ctx=n_ctx, sampler=sampler)
