"""WavLM Base+ SSL extractor (2 layers) for voice cloning
(miotts_tpu/models/wavlm.py).

One length-masked forward over padded 16 kHz waveforms: the conv feature
stack (wavlm-extractor.cpp:664-681), the feature projection and the
grouped positional conv (:684-739), and transformer layers with WavLM's
GRU-gated relative-position bias (:762-851). The SSL output is the mean of
the layer outputs (:853-864). Every step runs at f32 (TF32 is off, see
``device.select_device``); attention computes its scores, bias, mask and
softmax explicitly, as the JAX package does, with no fused attention call
whose masking or rounding differs.

The [T, T] relative-position bucket table is built on the host in f32
with the JAX package's sequence of operations (its ``log`` and ``floor``
decide a bucket exactly at a boundary), once for each frame count, and
uploaded once (``WavLMExtractor.bucket_table``).

``WavLMExtractor`` is the host side: decode, peak-normalize and resample
a reference to 16 kHz, pad it to a bucket of ``_WAV_BUCKETS`` (the JAX
package's ladder, so both pad a reference to the same length), and the
reference's non-finite fallback ladder (ssl -> pre-transformer features
-> deterministic audio statistics, :1016-1076).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import to_device, to_host
from ..gguf import GGUFReader
from ..ops.convs import conv1d_strided
from ..ops.masking import mask_time, time_mask
from ..ops.norms import layer_norm
from ..runtime.audio_io import load_audio, resample_linear
from ..runtime.device_dequant import device_put_packed


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """Hyperparameters read from GGUF KV; the JAX package's WavLMConfig."""
    sample_rate: int = 16000
    n_layers: int = 2
    n_heads: int = 12
    head_dim: int = 64
    embed_dim: int = 768
    num_buckets: int = 320
    max_distance: int = 800
    norm_eps: float = 1e-5
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    pos_conv_groups: int = 16
    pos_conv_kernel: int = 128

    def conv_out_len(self, n_in: int) -> int:
        """wavlm_conv_stack_out_len (wavlm-extractor.cpp:242-255)."""
        n = max(1, n_in)
        for k, s in zip(self.conv_kernel, self.conv_stride):
            if n < k:
                return 1
            n = max(1, (n - k) // s + 1)
        return n


def load_wavlm(path: str, device: torch.device) -> tuple[WavLMConfig, dict]:
    """A WavLM GGUF onto ``device`` at f32, in the JAX package's layout:
    linear weights [in, out], conv weights [out, in, k], one dict a layer;
    the host tree in one ``device_put_packed``."""
    with GGUFReader(path) as r:
        d = WavLMConfig()
        kernels = tuple(r.get_u32(f"wavlm.feat.conv{i}.kernel", d.conv_kernel[i])
                        for i in range(7))
        strides = tuple(r.get_u32(f"wavlm.feat.conv{i}.stride", d.conv_stride[i])
                        for i in range(7))
        cfg = WavLMConfig(
            sample_rate=r.get_u32("wavlm.sample_rate", d.sample_rate),
            n_layers=r.get_u32("wavlm.n_layers", d.n_layers),
            n_heads=r.get_u32("wavlm.n_heads", d.n_heads),
            head_dim=r.get_u32("wavlm.head_dim", d.head_dim),
            embed_dim=r.get_u32("wavlm.embed_dim", d.embed_dim),
            num_buckets=r.get_u32("wavlm.num_buckets", d.num_buckets),
            max_distance=r.get_u32("wavlm.max_distance", d.max_distance),
            norm_eps=r.get_f32("wavlm.layer_norm_eps", d.norm_eps),
            conv_kernel=kernels,
            conv_stride=strides,
        )

        def t(name, transpose=False):
            arr = r.tensor(name, dtype=np.float32)
            return np.ascontiguousarray(arr.T) if transpose else np.array(arr)

        w: dict[str, Any] = {
            "conv0_norm_w": t("wavlm.feat.conv0.norm.weight"),
            "conv0_norm_b": t("wavlm.feat.conv0.norm.bias"),
            "conv_w": [t(f"wavlm.feat.conv{i}.weight") for i in range(7)],  # [out, in, k]
            "proj_norm_w": t("wavlm.proj.norm.weight"),
            "proj_norm_b": t("wavlm.proj.norm.bias"),
            "proj_w": t("wavlm.proj.weight", transpose=True),
            "proj_b": t("wavlm.proj.bias"),
            "pos_conv_w": t("wavlm.pos_conv.weight"),  # [768, 48, 128] grouped
            "pos_conv_b": t("wavlm.pos_conv.bias"),
            "transformer_norm_w": t("wavlm.transformer.norm.weight"),
            "transformer_norm_b": t("wavlm.transformer.norm.bias"),
            "rel_embed": t("wavlm.layer.0.attn.rel_embed.weight"),  # [buckets, heads]
        }
        layers = []
        for i in range(cfg.n_layers):
            p = f"wavlm.layer.{i}"
            layers.append({
                "in_proj_w": t(f"{p}.attn.in_proj.weight", transpose=True),  # [768, 2304]
                "in_proj_b": t(f"{p}.attn.in_proj.bias"),
                "out_proj_w": t(f"{p}.attn.out_proj.weight", transpose=True),
                "out_proj_b": t(f"{p}.attn.out_proj.bias"),
                "gru_w": t(f"{p}.attn.gru.weight", transpose=True),  # [64, 8]
                "gru_b": t(f"{p}.attn.gru.bias"),
                "gru_const": t(f"{p}.attn.gru_const").reshape(-1),  # [heads]
                "norm1_w": t(f"{p}.norm1.weight"),
                "norm1_b": t(f"{p}.norm1.bias"),
                "ffn_w1": t(f"{p}.ffn.w1.weight", transpose=True),
                "ffn_b1": t(f"{p}.ffn.w1.bias"),
                "ffn_w2": t(f"{p}.ffn.w2.weight", transpose=True),
                "ffn_b2": t(f"{p}.ffn.w2.bias"),
                "norm2_w": t(f"{p}.norm2.weight"),
                "norm2_b": t(f"{p}.norm2.bias"),
            })
        w["layers"] = layers
    return cfg, device_put_packed(w, device)


# ---------------------------------------------------------------------------
# relative position buckets (host, f32)
# ---------------------------------------------------------------------------

def relative_position_bucket(relative_pos: np.ndarray, num_buckets: int,
                             max_distance: int) -> np.ndarray:
    """wavlm_relative_position_bucket (wavlm-extractor.cpp:257-279) on the
    host, with miotts_tpu/models/wavlm.py's f32 operations in its order:
    int32 distance, f32 log of n / max_exact, divided by the f32 log of
    max_distance / max_exact, times (half - max_exact), floored."""
    half = num_buckets // 2
    max_exact = half // 2
    rel = np.asarray(relative_pos).astype(np.int32)
    base = np.where(rel > 0, half, 0).astype(np.int32)
    n = np.abs(rel)
    nf = np.maximum(n, 1).astype(np.float32)
    denom = np.float32(np.log(float(max_distance) / float(max_exact)))
    log_val = max_exact + np.floor(
        np.log(nf / np.float32(max_exact)) / denom * np.float32(half - max_exact)
    ).astype(np.int32)
    log_val = np.minimum(log_val, half - 1)
    return base + np.where(n < max_exact, n, log_val)


def bucket_table(cfg: WavLMConfig, seq: int) -> np.ndarray:
    """[seq_q, seq_k] int64 bucket of (k - q) (wavlm-extractor.cpp:894-912)."""
    q = np.arange(seq, dtype=np.int32)
    return relative_position_bucket(q[None, :] - q[:, None], cfg.num_buckets,
                                    cfg.max_distance).astype(np.int64)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # ggml_gelu, the tanh approximation


def wavlm_forward(cfg: WavLMConfig, w: dict, wav: torch.Tensor, wav_lengths: torch.Tensor,
                  buckets: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """wav [B, S] 16 kHz mono (padded), wav_lengths [B] int32; ``buckets``
    the [T, T] bucket table of the output frame count on wav's device
    (built here when None). Returns (ssl [B, T, E], ssl_pre [B, T, E],
    frame_lengths [B] int32), everything at t >= a frame length exactly 0."""
    B, S = wav.shape
    x = wav[:, :, None].float()  # [B, S, 1]
    cur_len = wav_lengths.to(torch.int32)

    for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
        x = conv1d_strided(x, w["conv_w"][i], None, stride=s, pad=0)
        cur_len = torch.clamp(torch.div(cur_len - k, s, rounding_mode="floor") + 1, min=1)
        x = mask_time(x, cur_len)
        if i == 0:
            # GroupNorm(groups=channels): each channel's statistics over the
            # VALID frames only (F.group_norm would count the padding)
            m = time_mask(x.shape[1], cur_len).float()[:, :, None]
            cnt = torch.clamp(cur_len.float(), min=1.0)[:, None, None]
            mean = (x * m).sum(dim=1, keepdim=True) / cnt
            var = (torch.square(x - mean) * m).sum(dim=1, keepdim=True) / cnt
            x = (x - mean) * torch.rsqrt(var + cfg.norm_eps)
            x = mask_time(x * w["conv0_norm_w"] + w["conv0_norm_b"], cur_len)
        x = mask_time(_gelu(x), cur_len)

    seq_len = cur_len
    x = layer_norm(x, w["proj_norm_w"], w["proj_norm_b"], eps=cfg.norm_eps)
    x = mask_time(x @ w["proj_w"] + w["proj_b"], seq_len)  # [B, T, E]

    # grouped positional conv, k = 128, pad 64 a side: T + 1 frames, the
    # trailing one cropped; then bias, GELU, mask, residual
    T = x.shape[1]
    kp = cfg.pos_conv_kernel
    pos = F.conv1d(x.transpose(1, 2), w["pos_conv_w"], None, padding=kp // 2,
                   groups=cfg.pos_conv_groups).transpose(1, 2)
    pos = mask_time(_gelu(pos[:, :T, :] + w["pos_conv_b"]), seq_len)
    x = layer_norm(x + pos, w["transformer_norm_w"], w["transformer_norm_b"], eps=cfg.norm_eps)
    ssl_pre = mask_time(x, seq_len)
    x = ssl_pre

    if buckets is None:
        buckets = torch.from_numpy(bucket_table(cfg, T)).to(wav.device)
    raw_bias = w["rel_embed"][buckets].permute(2, 0, 1)  # [H, q, k]
    # a padded query row still sees its diagonal: no all -inf row
    eye = torch.eye(T, dtype=torch.bool, device=wav.device)
    kmask = time_mask(T, seq_len)[:, None, None, :] | eye  # [B, 1, q, k]

    H, HD, E = cfg.n_heads, cfg.head_dim, cfg.embed_dim
    scale = 1.0 / float(np.sqrt(HD))
    ssl_sum = None
    for lw in w["layers"]:
        # GRU-style gate from the layer input, per (query, head): gru_w
        # [HD, 8] on each head's HD-wide slice
        g = x.reshape(B, T, H, HD) @ lw["gru_w"] + lw["gru_b"]  # [B, T, H, 8]
        g0 = torch.sigmoid(g[..., :4].sum(dim=-1))
        g1 = torch.sigmoid(g[..., 4:].sum(dim=-1))
        gate = g0 * (g1 * lw["gru_const"] - 1.0) + 2.0  # [B, T(q), H]
        bias = raw_bias[None] * gate.permute(0, 2, 1)[:, :, :, None]  # [B, H, q, k]

        qkv = x @ lw["in_proj_w"] + lw["in_proj_b"]  # [B, T, 3E]
        q, k, v = (qkv[..., i * E:(i + 1) * E].reshape(B, T, H, HD).transpose(1, 2)
                   for i in range(3))  # [B, H, T, HD]
        scores = (q @ k.transpose(-1, -2)) * scale + bias
        scores = scores.masked_fill(~kmask, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        att = (probs @ v).transpose(1, 2).reshape(B, T, E)
        h = x + (att @ lw["out_proj_w"] + lw["out_proj_b"])

        n1 = layer_norm(h, lw["norm1_w"], lw["norm1_b"], eps=cfg.norm_eps)
        ff = _gelu(n1 @ lw["ffn_w1"] + lw["ffn_b1"]) @ lw["ffn_w2"] + lw["ffn_b2"]
        x = layer_norm(h + ff, lw["norm2_w"], lw["norm2_b"], eps=cfg.norm_eps)
        ssl_sum = x if ssl_sum is None else ssl_sum + x

    ssl = ssl_sum * (1.0 / max(1, cfg.n_layers))
    return mask_time(ssl, seq_len), ssl_pre, seq_len


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

_WAV_BUCKETS = (8000, 16000, 32000, 64000, 128000, 200000, 320000, 480000)


def _audio_stat_fallback(wav16k: np.ndarray, embed: int) -> np.ndarray:
    """Deterministic audio-stat pseudo-features (wavlm-extractor.cpp:1039-1071)."""
    hop, win = 320, 400
    total = len(wav16k)
    fb_frames = max(1, (total + hop - 1) // hop)
    out = np.zeros((fb_frames, embed), np.float32)
    d = np.arange(embed)
    alpha = 0.15 + 0.85 * ((d % 31) / 30.0)
    beta = ((d % 7) + 1) / 7.0
    sign = np.where((d & 1) == 1, 1.0, -1.0)
    for t in range(fb_frames):
        s0 = min(total - 1, t * hop)
        s1 = min(total, s0 + win)
        a = np.abs(wav16k[s0:s1].astype(np.float64))
        n = max(1, s1 - s0)
        mean_abs = a.sum() / n
        rms = np.sqrt((a * a).sum() / n)
        peak = a.max() if a.size else 0.0
        out[t] = ((alpha * rms + (1 - alpha) * mean_abs) * beta + 0.05 * peak * sign)
    return out


class WavLMExtractor:
    """WavLM weights on one device, the host's reference preprocessing, and
    the bucket tables uploaded so far (one a frame count)."""

    def __init__(self, path: str, device: torch.device, sharding=None):
        # ``sharding`` (an sp mesh's devices; the JAX package's replicated
        # placement): the chain is not split over the mesh, so the weights
        # land once, on its lead device, where the chain runs
        if sharding is not None:
            device = list(sharding)[0].device
        self.device = device
        self.config, self.weights = load_wavlm(path, device)
        self._tables: dict[int, tuple[np.ndarray, torch.Tensor]] = {}

    def bucket_table(self, seq: int) -> tuple[np.ndarray, torch.Tensor]:
        """The [seq, seq] bucket table on the host and on the device, built
        and uploaded on first use (an asynchronous copy from pinned memory
        on the current stream)."""
        if seq not in self._tables:
            host = bucket_table(self.config, seq)
            self._tables[seq] = (host, to_device(host, self.device))
        return self._tables[seq]

    def estimate_ssl_frames(self, source_rate: int, max_seconds: float = 20.0) -> int:
        n_src = max(1, round(source_rate * (max_seconds if max_seconds > 0 else 20.0)))
        n_wav = max(1, round(n_src * self.config.sample_rate / source_rate))
        return self.config.conv_out_len(n_wav)

    def preprocess_reference(self, audio_path: str, source_rate: int,
                             max_seconds: float = 20.0) -> np.ndarray:
        """Host side of reference processing: decode at the codec's rate,
        peak-normalize (wavlm-extractor.cpp:205-216), resample to 16 kHz."""
        wav_src, _ = load_audio(audio_path, target_rate=source_rate,
                                max_seconds=max_seconds if max_seconds > 0 else None)
        if wav_src.size == 0:
            raise ValueError("reference audio is empty")
        wav_src = wav_src / (np.abs(wav_src).max() + 1e-8)
        wav16k = resample_linear(wav_src, source_rate, self.config.sample_rate)
        if wav16k.size == 0:
            raise ValueError("resampling produced empty waveform")
        return wav16k

    @staticmethod
    def pick_wav_bucket(n: int) -> int:
        """The padded length of an n-sample 16 kHz reference: the first
        bucket that holds it, else a multiple of 80 000."""
        return next((b for b in _WAV_BUCKETS if n <= b), ((n + 79999) // 80000) * 80000)

    def extract_ssl_features(self, audio_path: str, source_rate: int,
                             max_seconds: float = 20.0) -> tuple[np.ndarray, int]:
        """Returns (ssl [T, embed], n_frames); fallback features replace
        non-finite ones as in the reference (which still returns success)."""
        return self.extract_from_wav16k(
            self.preprocess_reference(audio_path, source_rate, max_seconds))

    def extract_from_wav16k(self, wav16k: np.ndarray) -> tuple[np.ndarray, int]:
        n = int(wav16k.size)
        padded = np.zeros((1, self.pick_wav_bucket(n)), np.float32)
        padded[0, :n] = wav16k
        _, table = self.bucket_table(self.config.conv_out_len(padded.shape[1]))
        ssl, ssl_pre, fl = wavlm_forward(
            self.config, self.weights, to_device(padded, self.device),
            to_device(np.array([n], np.int32), self.device), table)
        n_frames = int(to_host(fl)[0])
        ssl = to_host(ssl[0, :n_frames].contiguous())
        if np.isfinite(ssl).all():
            return ssl, n_frames
        ssl_pre = to_host(ssl_pre[0, :n_frames].contiguous())
        if np.isfinite(ssl_pre).all():
            return ssl_pre, n_frames
        fb = _audio_stat_fallback(wav16k, self.config.embed_dim)
        return fb, fb.shape[0]
