"""The plain qwen2 forward, in float32, from the GGUF as written: the
reference the served tokens are judged by.

No cache, no batching, no kernels: one causal pass over a whole sequence.
``quant`` puts the control in its place: every matmul weight (not the
embedding lookup, norms or biases) rounded through float8 e4m3 or int8,
one scale a row, computed in float32 after that.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..gguf import Reader

_MATS = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down")


def quantize_rows(w: torch.Tensor, quant: str | None) -> torch.Tensor:
    """``w`` [out, in] rounded through ``quant`` with one absmax scale a row,
    returned dequantized in float32."""
    if quant is None:
        return w
    amax = w.abs().amax(dim=1, keepdim=True).clamp(min=1e-12)
    if quant == "int8":
        s = amax / 127.0
        return torch.round(w / s).clamp(-127, 127) * s
    if quant == "fp8":
        s = amax / 448.0
        return (w / s).to(torch.float8_e4m3fn).float() * s
    raise ValueError(f"unknown quant {quant!r}")


class LLM:
    def __init__(self, path: str, device: torch.device, quant: str | None = None):
        with Reader(path) as r:
            kv = r.kv
            arch = kv["general.architecture"]
            self.n_layers = int(kv[f"{arch}.block_count"])
            self.dim = int(kv[f"{arch}.embedding_length"])
            self.n_heads = int(kv[f"{arch}.attention.head_count"])
            self.n_kv = int(kv[f"{arch}.attention.head_count_kv"])
            self.eps = float(kv[f"{arch}.attention.layer_norm_rms_epsilon"])
            self.rope_base = float(kv[f"{arch}.rope.freq_base"])

            def t(name, q=False):
                x = torch.from_numpy(r.tensor(name)).to(device)
                return quantize_rows(x, quant) if q else x

            self.embd = t("token_embd.weight")
            self.layers = []
            for i in range(self.n_layers):
                blk = {m: t(f"blk.{i}.{m}.weight", q=True) for m in _MATS}
                for m in ("attn_q", "attn_k", "attn_v"):
                    blk[m + "_b"] = t(f"blk.{i}.{m}.bias")
                blk["attn_norm"] = t(f"blk.{i}.attn_norm.weight")
                blk["ffn_norm"] = t(f"blk.{i}.ffn_norm.weight")
                self.layers.append(blk)
            self.out_norm = t("output_norm.weight")
            self.head = t("output.weight" if r.has("output.weight") else "token_embd.weight",
                          q=True)
        self.hd = self.dim // self.n_heads

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * w

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """NEOX rotary embedding of x [T, H, D] at positions 0..T-1."""
        T, _, D = x.shape
        inv = self.rope_base ** (torch.arange(D // 2, device=x.device, dtype=torch.float32)
                                 * (-2.0 / D))
        ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] * inv
        c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        a, b = x[..., :D // 2], x[..., D // 2:]
        return torch.cat([a * c - b * s, a * s + b * c], dim=-1)

    @torch.no_grad()
    def logits(self, ids: list[int]) -> torch.Tensor:
        """Logits [T, vocab] f32 after each of ``ids``."""
        tok = torch.tensor(ids, device=self.embd.device)
        x = self.embd[tok]
        T = x.shape[0]
        g = self.n_heads // self.n_kv
        for blk in self.layers:
            h = self._norm(x, blk["attn_norm"])
            q = (h @ blk["attn_q"].t() + blk["attn_q_b"]).view(T, self.n_heads, self.hd)
            k = (h @ blk["attn_k"].t() + blk["attn_k_b"]).view(T, self.n_kv, self.hd)
            v = (h @ blk["attn_v"].t() + blk["attn_v_b"]).view(T, self.n_kv, self.hd)
            q, k = self._rope(q), self._rope(k)
            k = k.repeat_interleave(g, dim=1)
            v = v.repeat_interleave(g, dim=1)
            scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(self.hd)
            causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
            att = torch.einsum("hqk,khd->qhd", p, v).reshape(T, self.dim)
            x = x + att @ blk["attn_output"].t()
            h = self._norm(x, blk["ffn_norm"])
            x = x + (F.silu(h @ blk["ffn_gate"].t()) * (h @ blk["ffn_up"].t())) @ blk["ffn_down"].t()
        return self._norm(x, self.out_norm) @ self.head.t()
