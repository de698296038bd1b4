"""MioCodec decoder: audio codes -> STFT spectrogram -> waveform (wave mode)
or -> mel spectrogram -> bundled vocoder -> waveform (mel mode)
(miotts_tpu/models/miocodec.py). Wave mode runs the wave upsampler when
the codec has one (the 44.1 kHz codec: spt 1764, hop 441, one 2x stage).

One batched, length-masked forward over [B, N] padded code batches. Every
convolution and group norm is length-masked, so a padded bucket computes
the unpadded math in its valid region. Codec math runs at f32 (the
reference accumulates attention in f32 and the fidelity bar is mel-L1 <
1e-2); ``device.select_device`` turns TF32 off on the card. As in the JAX
package, ``MIOTTS_CODEC_MATMUL`` (float32, tensorfloat32 or bfloat16)
sets the precision of the trunk's and the synthesis head's matmuls and
convolutions (``ops/precision.py``), not the global encoder's.

Weights are a plain dict of tensors with the JAX package's tree layout:
linear weights pre-transposed to [in, out], transformer and resnet blocks
stacked along a leading layer axis.

The global (speaker) encoder, loaded when the GGUF carries its tensors,
turns WavLM SSL features into the 128-d embedding that conditions the
decoder (``encode_global_embedding``: a ConvNeXt backbone and attentive-
stats pooling). Mel mode without bundled vocoder tensors raises, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf import GGUFReader
from ..ops.attention import banded_attention
from ..ops.convs import conv1d_depthwise_same, conv1d_same, conv_transpose1d, linear_interpolate
from ..ops.istft import dft_tables, spec_to_audio
from ..ops.masking import mask_time, time_mask
from ..ops.norms import adaln_modulate, layer_norm, masked_group_norm
from ..ops.precision import codec_matmul, mm, operand
from ..ops.rope import apply_rope
from ..parallel import sequence as seq
from ..runtime.device_dequant import device_put_packed
from .vocoder import load_vocoder_weights, vocoder_decode, vocoder_decode_sp


@dataclasses.dataclass(frozen=True)
class MioCodecConfig:
    """Hyperparameters read from GGUF KV; the same fields as the JAX
    package's MioCodecConfig."""
    model_type: int = 0  # 0 = wave (stft), 1 = mel
    sample_rate: int = 24000
    n_fft: int = 1920
    hop_length: int = 480
    n_mels: int = 0
    samples_per_token: int = 960
    prenet_layers: int = 6
    prenet_dim: int = 768
    prenet_heads: int = 12
    prenet_ff: int = 2048
    prenet_window: int = 65
    decoder_layers: int = 8
    decoder_dim: int = 512
    decoder_heads: int = 8
    decoder_ff: int = 1536
    decoder_window: int = 65
    decoder_adanorm_dim: int = 128
    resnet_blocks: int = 2
    resnet_groups: int = 32
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    group_norm_eps: float = 1e-6
    dynamic_global: bool = True
    has_vocoder: bool = False
    mel_postnet_layers: int = 0
    mel_postnet_kernel_size: int = 0
    global_encoder_input_channels: int = 768
    global_encoder_output_channels: int = 128
    global_encoder_dim: int = 384
    global_encoder_intermediate_dim: int = 1152
    global_encoder_layers: int = 4
    wave_upsampler_factors: tuple[int, ...] = ()
    wave_upsampler_kernel_sizes: tuple[int, ...] = ()
    vocab_size: int = 12800
    vocoder_upsample_rates: tuple[int, ...] = ()
    vocoder_num_kernels: int = 0

    @property
    def wave_upsampler_total_factor(self) -> int:
        f = 1
        for x in self.wave_upsampler_factors:
            f *= x
        return f

    def stft_frames(self, n_tokens: int) -> int:
        return max(1, (n_tokens * self.samples_per_token) // max(1, self.hop_length))

    def decoder_frames(self, n_tokens: int) -> int:
        sf = self.stft_frames(n_tokens)
        tf = self.wave_upsampler_total_factor
        return max(1, sf // tf if tf > 1 else sf)


def choose_num_groups(groups: int, channels: int) -> int:
    """GroupNorm group-count adaptation (miocodec-decoder.cpp:1345-1351)."""
    g = max(1, min(groups, channels))
    while g > 1 and channels % g != 0:
        g -= 1
    return max(1, g)


def check_supported(cfg: MioCodecConfig) -> None:
    """Raise for the codec variants the port does not run."""
    if cfg.model_type == 1 and not cfg.has_vocoder:
        raise NotImplementedError("mel-mode model has no bundled MioVocoder tensors")
    if cfg.model_type not in (0, 1):
        raise NotImplementedError(f"unknown MioCodec model_type {cfg.model_type}")


# ---------------------------------------------------------------------------
# Weight loading
# ---------------------------------------------------------------------------

_TRANSFORMER_SPEC = {
    "attn_norm_w": ("{p}.blk.{{i}}.attn_norm.weight", False),
    "attn_norm_b": ("{p}.blk.{{i}}.attn_norm.bias", False),
    "wq": ("{p}.blk.{{i}}.attn_q.weight", True),
    "wk": ("{p}.blk.{{i}}.attn_k.weight", True),
    "wv": ("{p}.blk.{{i}}.attn_v.weight", True),
    "wo": ("{p}.blk.{{i}}.attn_output.weight", True),
    "ffn_norm_w": ("{p}.blk.{{i}}.ffn_norm.weight", False),
    "ffn_norm_b": ("{p}.blk.{{i}}.ffn_norm.bias", False),
    "w1": ("{p}.blk.{{i}}.ffn_gate.weight", True),
    "w2": ("{p}.blk.{{i}}.ffn_down.weight", True),
    "w3": ("{p}.blk.{{i}}.ffn_up.weight", True),
}

_COND_SPEC = {
    "attn_cond_w": ("{p}.blk.{{i}}.attn_cond.weight", True),
    "attn_cond_b": ("{p}.blk.{{i}}.attn_cond.bias", False),
    "ffn_cond_w": ("{p}.blk.{{i}}.ffn_cond.weight", True),
    "ffn_cond_b": ("{p}.blk.{{i}}.ffn_cond.bias", False),
}

_RESNET_SPEC = {
    "norm1_w": ("{p}.{{i}}.norm1.weight", False),
    "norm1_b": ("{p}.{{i}}.norm1.bias", False),
    "conv1_w": ("{p}.{{i}}.conv1.weight", False),
    "conv1_b": ("{p}.{{i}}.conv1.bias", False),
    "norm2_w": ("{p}.{{i}}.norm2.weight", False),
    "norm2_b": ("{p}.{{i}}.norm2.bias", False),
    "conv2_w": ("{p}.{{i}}.conv2.weight", False),
    "conv2_b": ("{p}.{{i}}.conv2.bias", False),
}


def _spec_with_prefix(spec: dict, prefix: str) -> dict:
    return {k: (pat.format(p=prefix), tr) for k, (pat, tr) in spec.items()}


def _t(x: np.ndarray) -> np.ndarray:
    """Linear weight [out, in] -> [in, out] for x @ w."""
    return np.ascontiguousarray(x.T)


def _stack_blocks(get, n: int, spec: dict, optional: frozenset = frozenset()) -> dict:
    out: dict[str, np.ndarray | None] = {}
    for field, (pattern, transpose) in spec.items():
        mats = []
        for i in range(n):
            arr = get(pattern.format(i=i))
            if arr is None:
                break
            mats.append(_t(arr) if transpose else arr)
        if len(mats) < n:
            if field not in optional:
                raise KeyError(f"missing tensor: {pattern.format(i=len(mats))}")
            out[field] = None
        else:
            out[field] = np.stack(mats)
    return out


def read_miocodec_config(r: GGUFReader) -> MioCodecConfig:
    def kv_u(key, default):
        return r.get_u32(f"miocodec.{key}", default)

    def kv_f(key, default):
        return r.get_f32(f"miocodec.{key}", default)

    ups_factors: tuple[int, ...] = ()
    ups_kernels: tuple[int, ...] = ()
    if kv_u("wave_upsampler_layers", 0):
        ups_factors = tuple(int(x) for x in r.tensor("miocodec.wave_upsampler.factors"))
        ups_kernels = tuple(int(x) for x in r.tensor("miocodec.wave_upsampler.kernel_sizes"))
    voc_rates: tuple[int, ...] = ()
    voc_num_kernels = 0
    if kv_u("has_vocoder", 0):
        voc_rates = tuple(int(x) for x in r.tensor("miovocoder.upsample_rates"))
        voc_num_kernels = r.get_u32("miovocoder.num_kernels", 0)

    d = MioCodecConfig()
    return MioCodecConfig(
        model_type=kv_u("model_type", d.model_type),
        sample_rate=kv_u("sample_rate", d.sample_rate),
        n_fft=kv_u("n_fft", d.n_fft),
        hop_length=kv_u("hop_length", d.hop_length),
        n_mels=kv_u("n_mels", d.n_mels),
        samples_per_token=kv_u("samples_per_token", d.samples_per_token),
        prenet_layers=kv_u("prenet_layers", d.prenet_layers),
        prenet_dim=kv_u("prenet_dim", d.prenet_dim),
        prenet_heads=kv_u("prenet_heads", d.prenet_heads),
        prenet_ff=kv_u("prenet_ff", d.prenet_ff),
        prenet_window=kv_u("prenet_window", d.prenet_window),
        decoder_layers=kv_u("decoder_layers", d.decoder_layers),
        decoder_dim=kv_u("decoder_dim", d.decoder_dim),
        decoder_heads=kv_u("decoder_heads", d.decoder_heads),
        decoder_ff=kv_u("decoder_ff", d.decoder_ff),
        decoder_window=kv_u("decoder_window", d.decoder_window),
        decoder_adanorm_dim=kv_u("decoder_adanorm_dim", d.decoder_adanorm_dim),
        resnet_blocks=kv_u("resnet_blocks", d.resnet_blocks),
        resnet_groups=kv_u("resnet_groups", d.resnet_groups),
        rope_theta=kv_f("rope_theta", d.rope_theta),
        norm_eps=kv_f("norm_eps", d.norm_eps),
        group_norm_eps=kv_f("group_norm_eps", d.group_norm_eps),
        dynamic_global=bool(kv_u("dynamic_global", 1)),
        has_vocoder=bool(kv_u("has_vocoder", 0)),
        mel_postnet_layers=kv_u("mel_postnet_layers", 0),
        mel_postnet_kernel_size=kv_u("mel_postnet_kernel_size", 0),
        global_encoder_input_channels=kv_u("global_encoder.input_channels",
                                           d.global_encoder_input_channels),
        global_encoder_output_channels=kv_u("global_encoder.output_channels",
                                            d.global_encoder_output_channels),
        global_encoder_dim=kv_u("global_encoder.dim", d.global_encoder_dim),
        global_encoder_intermediate_dim=kv_u("global_encoder.intermediate_dim",
                                             d.global_encoder_intermediate_dim),
        global_encoder_layers=kv_u("global_encoder.num_layers", d.global_encoder_layers),
        wave_upsampler_factors=ups_factors,
        wave_upsampler_kernel_sizes=ups_kernels,
        vocab_size=int(r.tensors["token_embd"].shape[0]),
        vocoder_upsample_rates=voc_rates,
        vocoder_num_kernels=voc_num_kernels,
    )


def load_miocodec(path: str, device: torch.device, sharding=None
                  ) -> tuple[MioCodecConfig, dict | list[dict]]:
    """Load a miocodec-dec GGUF (wave mode, or mel mode with its vocoder)
    onto ``device`` at f32, the host tree in one ``device_put_packed``; with
    ``sharding`` (an sp mesh's devices) replicated over them instead, one
    tree a rank, uploaded once a physical device."""
    with GGUFReader(path) as r:
        cfg = read_miocodec_config(r)
        check_supported(cfg)

        def get(name):
            return r.tensor(name, dtype=np.float32) if r.has_tensor(name) else None

        w: dict[str, Any] = {
            "token_embd": get("token_embd"),
            "prenet_blocks": _stack_blocks(get, cfg.prenet_layers,
                                           _spec_with_prefix(_TRANSFORMER_SPEC, "wave_prenet")),
            "prenet_norm_w": get("wave_prenet.norm.weight"),
            "prenet_norm_b": get("wave_prenet.norm.bias"),
            "prenet_out_w": _t(get("wave_prenet.output.weight")),
            "prenet_out_b": get("wave_prenet.output.bias"),
            "upsample_w": get("wave_upsample.weight"),  # ConvTranspose1d [in, out, k]
            "upsample_b": get("wave_upsample.bias"),
        }
        if cfg.model_type == 0:
            for key, prefix in (("prior", "wave_prior"), ("post", "wave_post")):
                w[key] = _stack_blocks(get, cfg.resnet_blocks,
                                       _spec_with_prefix(_RESNET_SPEC, prefix))
        dec_spec = dict(_spec_with_prefix(_TRANSFORMER_SPEC, "wave_decoder"))
        dec_spec.update(_spec_with_prefix(_COND_SPEC, "wave_decoder"))
        optional = frozenset({"attn_norm_w", "attn_norm_b", "ffn_norm_w", "ffn_norm_b"}
                             if cfg.dynamic_global else
                             {"attn_cond_w", "attn_cond_b", "ffn_cond_w", "ffn_cond_b"})
        w["decoder_blocks"] = _stack_blocks(get, cfg.decoder_layers, dec_spec, optional=optional)
        if cfg.dynamic_global:
            w["norm_cond_w"] = _t(get("wave_decoder.norm_cond.weight"))
            w["norm_cond_b"] = get("wave_decoder.norm_cond.bias")
        else:
            w["decoder_norm_w"] = get("wave_decoder.norm.weight")
            w["decoder_norm_b"] = get("wave_decoder.norm.bias")
        w["istft_out_w"] = _t(get("istft_head.out.weight"))
        w["istft_out_b"] = get("istft_head.out.bias")
        if cfg.model_type == 0:
            w["istft_tables"] = dft_tables(cfg.n_fft)
        if cfg.wave_upsampler_factors:
            resblk = _spec_with_prefix(_RESNET_SPEC, "wave_upsampler.resblk")
            w["wave_upsampler"] = [{
                "up_w": get(f"wave_upsampler.up.{i}.weight"),  # ConvTranspose1d [in, out, k]
                "up_b": get(f"wave_upsampler.up.{i}.bias"),
                "snake_alpha": get(f"wave_upsampler.snake.{i}.alpha"),
                "snake_beta": get(f"wave_upsampler.snake.{i}.beta"),
                "resblk": {k: get(pat.format(i=i)) for k, (pat, _) in resblk.items()},
            } for i in range(len(cfg.wave_upsampler_factors))]
            w["ups_out_proj_w"] = _t(get("wave_upsampler.out_proj.weight"))
            w["ups_out_proj_b"] = get("wave_upsampler.out_proj.bias")
            w["ups_out_snake_alpha"] = get("wave_upsampler.out_snake.alpha")
            w["ups_out_snake_beta"] = get("wave_upsampler.out_snake.beta")
        if cfg.model_type == 1 and cfg.mel_postnet_layers > 0:
            w["mel_postnet"] = _stack_blocks(get, cfg.mel_postnet_layers, {
                "conv_w": ("mel_postnet.{i}.conv.weight", False),
                "conv_b": ("mel_postnet.{i}.conv.bias", False),
                "norm_w": ("mel_postnet.{i}.norm.weight", False),
                "norm_b": ("mel_postnet.{i}.norm.bias", False),
            })
        if cfg.has_vocoder:
            w["vocoder"] = load_vocoder_weights(get, cfg)
        if r.has_tensor("global_encoder.backbone.embed.weight"):
            w["global_encoder"] = _load_global_encoder(get, cfg)
    return cfg, device_put_packed(w, device, sharding=sharding)


def _load_global_encoder(get, cfg: MioCodecConfig) -> dict:
    """The optional global encoder (miocodec-decoder.cpp:713-744)."""
    g = "global_encoder.backbone"
    return {
        "embed_w": get(f"{g}.embed.weight"),  # conv [dim, in, k]
        "embed_b": get(f"{g}.embed.bias"),
        "norm_w": get(f"{g}.norm.weight"),
        "norm_b": get(f"{g}.norm.bias"),
        "final_norm_w": get(f"{g}.final_norm.weight"),
        "final_norm_b": get(f"{g}.final_norm.bias"),
        "blocks": _stack_blocks(get, cfg.global_encoder_layers, {
            "dwconv_w": (g + ".blk.{i}.dwconv.weight", False),
            "dwconv_b": (g + ".blk.{i}.dwconv.bias", False),
            "norm_w": (g + ".blk.{i}.norm.weight", False),
            "norm_b": (g + ".blk.{i}.norm.bias", False),
            "pw1_w": (g + ".blk.{i}.pw1.weight", True),
            "pw1_b": (g + ".blk.{i}.pw1.bias", False),
            "pw2_w": (g + ".blk.{i}.pw2.weight", True),
            "pw2_b": (g + ".blk.{i}.pw2.bias", False),
            "gamma": (g + ".blk.{i}.gamma", False),
        }),
        "pool_attn0_w": get("global_encoder.pool.attn0.weight"),  # conv k=1
        "pool_attn0_b": get("global_encoder.pool.attn0.bias"),
        "pool_attn2_w": get("global_encoder.pool.attn2.weight"),
        "pool_attn2_b": get("global_encoder.pool.attn2.bias"),
        "pool_proj_w": _t(get("global_encoder.pool.proj.weight")),
        "pool_proj_b": get("global_encoder.pool.proj.bias"),
        "pool_norm_w": get("global_encoder.pool.norm.weight"),
        "pool_norm_b": get("global_encoder.pool.norm.bias"),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer(blocks: dict, i: int) -> dict:
    return {k: (v[i] if v is not None else None) for k, v in blocks.items()}


def _attn_inputs(x, blk: dict, n_heads: int, positions, rope_theta: float, norm_eps: float,
                 cond_act) -> tuple:
    """One block's q, k, v [B, T, H, D] (RoPE at ``positions``) and its
    attention gate (None unconditioned) from x [B, T, C]."""
    B, T, C = x.shape
    hd = C // n_heads
    if cond_act is not None:
        p = mm(cond_act, blk["attn_cond_w"]) + blk["attn_cond_b"]  # [B, 3C]
        shift, scale, gate = p[:, :C], p[:, C:2 * C], p[:, 2 * C:]
        xn = adaln_modulate(layer_norm(x, eps=norm_eps), shift, scale)
    else:
        gate = None
        xn = layer_norm(x, blk["attn_norm_w"], blk["attn_norm_b"], eps=norm_eps)
    q = apply_rope(mm(xn, blk["wq"]).reshape(B, T, n_heads, hd), positions, rope_theta)
    k = apply_rope(mm(xn, blk["wk"]).reshape(B, T, n_heads, hd), positions, rope_theta)
    v = mm(xn, blk["wv"]).reshape(B, T, n_heads, hd)
    return q, k, v, gate


def _block_out(x, att, blk: dict, gate, norm_eps: float, cond_act) -> torch.Tensor:
    """The rest of one block after attention: output projection (gated),
    residual, the (modulated) SwiGLU FFN and its residual."""
    B, T, C = x.shape
    out = mm(att.reshape(B, T, C), blk["wo"])
    if gate is not None:
        out = out * gate[:, None, :]
    h = x + out

    if cond_act is not None:
        p = mm(cond_act, blk["ffn_cond_w"]) + blk["ffn_cond_b"]
        shift, scale, fgate = p[:, :C], p[:, C:2 * C], p[:, 2 * C:]
        fn = adaln_modulate(layer_norm(h, eps=norm_eps), shift, scale)
    else:
        fgate = None
        fn = layer_norm(h, blk["ffn_norm_w"], blk["ffn_norm_b"], eps=norm_eps)
    ff = mm(F.silu(mm(fn, blk["w1"])) * mm(fn, blk["w3"]), blk["w2"])
    if fgate is not None:
        ff = ff * fgate[:, None, :]
    return h + ff


def _transformer_stack(x, blocks: dict, n_heads: int, lengths, window: int, rope_theta: float,
                       norm_eps: float, cond_act) -> torch.Tensor:
    """Stacked transformer blocks over x [B, T, C]; ``cond_act`` [B, Dc]
    (SiLU-activated speaker embedding) turns on AdaLN-Zero conditioning."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for i in range(blocks["wq"].shape[0]):
        blk = _layer(blocks, i)
        q, k, v, gate = _attn_inputs(x, blk, n_heads, positions, rope_theta, norm_eps, cond_act)
        x = _block_out(x, banded_attention(q, k, v, lengths, window), blk, gate, norm_eps,
                       cond_act)
    return x


def _resnet_block(x, blk: dict, lengths, groups: int, gn_eps: float) -> torch.Tensor:
    """GroupNorm/SiLU/conv residual block; re-masked after every bias so
    padded rows stay zero."""
    g = choose_num_groups(groups, x.shape[-1])

    def half(y, nw, nb, cw, cb):
        y = masked_group_norm(y, lengths, g, eps=gn_eps)
        y = F.silu(y * nw + nb)
        y = conv1d_same(operand(mask_time(y, lengths)), operand(cw), cb)
        return mask_time(y, lengths)

    y = half(x, blk["norm1_w"], blk["norm1_b"], blk["conv1_w"], blk["conv1_b"])
    y = half(y, blk["norm2_w"], blk["norm2_b"], blk["conv2_w"], blk["conv2_b"])
    return x + y


def _snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SnakeBeta with log-scale parameters (miocodec-decoder.cpp:1332-1343):
    x + sin^2(e^alpha x) / (e^beta + 1e-9) in f32, cast back. Keeps zeros."""
    s = torch.sin(x.float() * torch.exp(alpha.float()))
    return (x + (s * s) / (torch.exp(beta.float()) + 1e-9)).to(x.dtype)


def _wave_upsample(cfg: MioCodecConfig, w: dict, x: torch.Tensor, frame_len: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The wave upsampler's stages (each: conv transpose with stride f,
    cropped by (k - f) // 2 a side, then snake and a resnet block), then
    out_proj and a snake. Returns (x, frame lengths)."""
    for stage, f, k in zip(w["wave_upsampler"], cfg.wave_upsampler_factors,
                           cfg.wave_upsampler_kernel_sizes):
        pad = max(0, (k - f) // 2)
        x = conv_transpose1d(operand(mask_time(x, frame_len)), operand(stage["up_w"]),
                             stage["up_b"], stride=f)
        if pad > 0:
            x = x[:, pad:x.shape[1] - pad, :]
        frame_len = (frame_len - 1) * f + k - 2 * pad
        x = _snake_beta(mask_time(x, frame_len), stage["snake_alpha"], stage["snake_beta"])
        x = _resnet_block(x, stage["resblk"], frame_len, cfg.resnet_groups, cfg.group_norm_eps)
    x = mm(x, w["ups_out_proj_w"]) + w["ups_out_proj_b"]
    x = _snake_beta(x, w["ups_out_snake_alpha"], w["ups_out_snake_beta"])
    return mask_time(x, frame_len), frame_len


def codec_decode_spec(cfg: MioCodecConfig, w, tokens: torch.Tensor,
                      token_lengths: torch.Tensor, cond: torch.Tensor | None,
                      interp_anchor_tokens: int | None = None, sp_mesh=None, *, matmul: str
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, N] codes (padded), token_lengths [B] int32, cond [B, Dc]
    speaker embedding or None (static models). Returns (spec [B, F, bins],
    frame_lengths [B]), bins = n_fft + 2 (wave) or n_mels (mel). ``interp_anchor_tokens`` pins the bilinear resize
    ratio to a fixed token count (None: the ratio from the true lengths).
    The trunk's matmuls and convolutions run at the precision ``matmul``
    (a ``MIOTTS_CODEC_MATMUL`` mode; ``ops/precision.py``). ``sp_mesh`` (an
    ("sp",) mesh, ``parallel/mesh.make_sp_mesh``) splits the decode's time
    axis over its ranks (``w`` then the weights, or one tree a rank); the
    spec comes back whole on the mesh's lead device."""
    with codec_matmul(matmul):
        if sp_mesh is None:
            return _codec_decode_spec(cfg, w, tokens, token_lengths, cond, interp_anchor_tokens)
        spec, frame_len = _sp_decode_spec(cfg, _rank_trees(w, sp_mesh), tokens, token_lengths,
                                          cond, interp_anchor_tokens, sp_mesh)
        return seq.join(spec), frame_len


def _codec_decode_spec(cfg: MioCodecConfig, w: dict, tokens: torch.Tensor,
                       token_lengths: torch.Tensor, cond: torch.Tensor | None,
                       interp_anchor_tokens: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    check_supported(cfg)
    B, N = tokens.shape
    dev = tokens.device
    stft_len = torch.clamp((token_lengths * cfg.samples_per_token) // cfg.hop_length, min=1)
    tf = cfg.wave_upsampler_total_factor
    dec_len = torch.clamp(stft_len // tf, min=1) if tf > 1 else stft_len
    F_dec = cfg.decoder_frames(N)

    cond_act = None
    if cfg.dynamic_global:
        c = cond if cond is not None else torch.zeros((B, cfg.decoder_adanorm_dim), device=dev)
        cond_act = F.silu(c.float())

    x = mask_time(w["token_embd"][tokens.long()], token_lengths)
    x = _transformer_stack(x, w["prenet_blocks"], cfg.prenet_heads, token_lengths,
                           cfg.prenet_window, cfg.rope_theta, cfg.norm_eps, None)
    x = layer_norm(x, w["prenet_norm_w"], w["prenet_norm_b"], eps=cfg.norm_eps)
    x = mask_time(mm(x, w["prenet_out_w"]) + w["prenet_out_b"], token_lengths)

    K_up = w["upsample_w"].shape[-1]
    y = conv_transpose1d(operand(x), operand(w["upsample_w"]), w["upsample_b"], stride=2)
    src_len = (token_lengths - 1) * 2 + K_up
    y = mask_time(y, src_len)
    scale_override = None
    if interp_anchor_tokens is not None:
        a = interp_anchor_tokens
        scale_override = ((a - 1) * 2 + K_up, cfg.decoder_frames(a))
    y = linear_interpolate(y, src_len, dec_len, F_dec, scale_override=scale_override)
    y = mask_time(y, dec_len)

    if cfg.model_type == 0:
        for i in range(cfg.resnet_blocks):
            y = _resnet_block(y, {k: v[i] for k, v in w["prior"].items()}, dec_len,
                              cfg.resnet_groups, cfg.group_norm_eps)

    x = _transformer_stack(y, w["decoder_blocks"], cfg.decoder_heads, dec_len,
                           cfg.decoder_window, cfg.rope_theta, cfg.norm_eps, cond_act)
    if cfg.dynamic_global:
        dim = cfg.decoder_dim
        p = mm(cond_act, w["norm_cond_w"]) + w["norm_cond_b"]  # [B, 2*dim]
        x = adaln_modulate(layer_norm(x, eps=cfg.norm_eps), p[:, :dim], p[:, dim:])
    else:
        x = layer_norm(x, w["decoder_norm_w"], w["decoder_norm_b"], eps=cfg.norm_eps)

    frame_len = dec_len
    if cfg.model_type == 0:
        for i in range(cfg.resnet_blocks):
            x = _resnet_block(mask_time(x, dec_len), {k: v[i] for k, v in w["post"].items()},
                              dec_len, cfg.resnet_groups, cfg.group_norm_eps)
        if cfg.wave_upsampler_factors:
            x, frame_len = _wave_upsample(cfg, w, x, frame_len)

    spec = mask_time(mm(x, w["istft_out_w"]) + w["istft_out_b"], frame_len)
    return spec, frame_len


def codec_synthesize(cfg: MioCodecConfig, w, tokens: torch.Tensor,
                     token_lengths: torch.Tensor, cond: torch.Tensor | None,
                     interp_anchor_tokens: int | None = None,
                     peak_normalize: bool = True, sp_mesh=None, *, matmul: str
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Codes -> waveform. Returns (audio [B, S_max], n_samples [B]); audio
    is peak-normalized per example like mio_tts_synthesize unless
    ``peak_normalize`` is False. Wave mode goes through the iSTFT head, mel
    mode through the bundled vocoder, whose output length sets n_samples.
    The trunk and the head run at the precision ``matmul`` (a
    ``MIOTTS_CODEC_MATMUL`` mode). ``sp_mesh`` splits the time axis over its
    ranks (``codec_synthesize_sharded``); the audio comes back whole on the
    mesh's lead device."""
    if sp_mesh is not None:
        audio, n_samples = codec_synthesize_sharded(
            cfg, w, tokens, token_lengths, cond, interp_anchor_tokens, peak_normalize, sp_mesh,
            matmul=matmul)
        return seq.join(audio), n_samples
    spec, frame_len = codec_decode_spec(cfg, w, tokens, token_lengths, cond,
                                        interp_anchor_tokens, matmul=matmul)
    with codec_matmul(matmul):
        if cfg.model_type == 0:
            audio = spec_to_audio(spec, frame_len, cfg.n_fft, cfg.hop_length, w["istft_tables"])
            n_samples = istft_samples(cfg, frame_len)
        else:
            audio, n_samples = vocoder_decode(cfg, w, spec, frame_len)
    audio = audio * time_mask(audio.shape[1], n_samples).to(audio.dtype)
    if peak_normalize:
        finite = torch.where(torch.isfinite(audio), audio, torch.zeros((), device=audio.device))
        peak = finite.abs().amax(dim=1)
        gain = torch.where(peak > 0.98, 0.95 / torch.clamp(peak, min=1e-9),
                           torch.ones((), device=audio.device))
        audio = audio * gain[:, None]
    return audio, n_samples


def istft_samples(cfg: MioCodecConfig, frame_len: torch.Tensor) -> torch.Tensor:
    """The iSTFT head's valid samples of ``frame_len`` frames."""
    n_pad = (cfg.n_fft - cfg.hop_length) // 2
    return (frame_len - 1) * cfg.hop_length + cfg.n_fft - 2 * n_pad


# ---------------------------------------------------------------------------
# Sequence parallelism: the forward with its time axis split over an ("sp",)
# mesh (parallel/sequence.py). The JAX package re-pins the time axis after
# each resampling seam and lets GSPMD derive the halos, reductions and
# gathers, with attention pinned to its XLA path and the vocoder to
# impl="xla" because a pallas_call is opaque to the partitioner
# (miotts_tpu/models/miocodec.py:476-489, 598-603). Here every op is written
# for a rank's rows, and the kernels stay on the path: K1 runs on each
# rank's halo-extended q/k/v, K4-K6 on each rank's halo-extended vocoder
# stage. Per op, what a rank reads beyond its own rows:
#
# - the token embedding, mask_time, LayerNorm, AdaLN, every matmul, the
#   SwiGLU FFN, the snake, the DFT: nothing (per frame);
# - banded attention (window w): RoPE at global positions; k and v get w//2
#   rows of halo a side (trimmed at the global edges, so no key before row
#   0 or past the axis exists), q is zero-padded to match, K1 runs with the
#   rank's local lengths and the halo rows of its output are dropped. Every
#   key a rank's own query admits, (|k - q| <= w//2 and k < length) or
#   k == q, lies in the extended part, so a rank's rows equal the mesh-less
#   rows;
# - conv transposes (stride 2, and the wave upsampler's stride f with its
#   (k - f)//2 crop): the input rows that reach a rank's output rows, the
#   output re-split at its new resolution (``seq.conv_transpose``);
# - the bilinear resize: its source rows by global index (``seq.interpolate``);
# - masked GroupNorm: two ``seq.sp_sum`` (mean, then centered variance);
# - resnet "same" convs of k taps: k//2 rows a side;
# - the iSTFT overlap-add: the frames that reach a rank's samples
#   (``seq.overlap_add``), the peak: ``seq.sp_max``;
# - mel mode: ``models/vocoder.py vocoder_decode_sp``.
# ---------------------------------------------------------------------------

def _rank_trees(w, mesh) -> list:
    """One weight tree a rank: ``w`` as given (a list, ``load_miocodec``'s
    sharded form) or the one tree for every rank."""
    n = mesh.devices.size
    trees = list(w) if isinstance(w, (list, tuple)) else [w] * n
    if len(trees) != n:
        raise ValueError(f"{len(trees)} weight trees for an sp mesh of {n} ranks")
    return trees


def _sp_transformer_stack(x: "seq.Sharded", blocks: list, n_heads: int, lengths: list,
                          window: int, rope_theta: float, norm_eps: float,
                          cond_act: list) -> "seq.Sharded":
    """``_transformer_stack`` over split rows: a layer's q/k/v on each
    rank's own rows (RoPE at their global positions), k and v halo-extended
    by window//2 rows, K1 (``banded_attention``) on the extended part with
    its local lengths, the halo query rows dropped."""
    mesh = x.mesh
    half = max(0, window // 2)
    ranges = x.ranges
    positions = seq.per_rank(mesh, lambda r: torch.arange(
        ranges[r][0], ranges[r][1], dtype=torch.int32, device=x.parts[r].device))
    parts = list(x.parts)
    for i in range(blocks[0]["wq"].shape[0]):
        blks = [_layer(b, i) for b in blocks]
        qkv = seq.per_rank(mesh, lambda r: _attn_inputs(parts[r], blks[r], n_heads, positions[r],
                                                        rope_theta, norm_eps, cond_act[r]))
        k_ext, v_ext = (seq.halo(seq.Sharded([t[j] for t in qkv], x.starts, x.total, mesh),
                                 half, half, edge="trim") for j in (1, 2))

        def attend(r):
            (a, b), e0 = ranges[r], k_ext.starts[r]
            rows = k_ext.parts[r].shape[1]
            q = F.pad(qkv[r][0], (0, 0, 0, 0, a - e0, e0 + rows - b))
            att = banded_attention(q, k_ext.parts[r], v_ext.parts[r],
                                   seq.local_lengths(lengths[r], e0, rows), window)
            return _block_out(parts[r], att[:, a - e0:b - e0], blks[r], qkv[r][3], norm_eps,
                              cond_act[r])
        parts = seq.per_rank(mesh, attend)
    return seq.Sharded(parts, list(x.starts), x.total, mesh)


def _sp_resnet_block(x: "seq.Sharded", blks: list, lengths: list, groups: int,
                     gn_eps: float) -> "seq.Sharded":
    """``_resnet_block`` over split rows: the GroupNorm's statistics summed
    over every rank, each conv on a halo of k//2 rows."""
    g = choose_num_groups(groups, x.parts[0].shape[-1])

    def half(y, nw, nb, cw, cb):
        y = seq.group_norm(y, lengths, g, gn_eps)
        reach = blks[0][cw].shape[-1] // 2

        def conv(r, p, start):
            ll = seq.local_lengths(lengths[r], start, p.shape[1])
            p = F.silu(p * blks[r][nw] + blks[r][nb])
            return mask_time(conv1d_same(operand(mask_time(p, ll)), operand(blks[r][cw]),
                                         blks[r][cb]), ll)
        return seq.on_halo(y, reach, reach, conv)

    y = half(x, "norm1_w", "norm1_b", "conv1_w", "conv1_b")
    y = half(y, "norm2_w", "norm2_b", "conv2_w", "conv2_b")
    return seq.map_rows(x, lambda r, p, start: p + y.parts[r])


def _sp_wave_upsample(cfg: MioCodecConfig, ws: list, x: "seq.Sharded", frame_len: torch.Tensor
                      ) -> tuple["seq.Sharded", torch.Tensor]:
    """``_wave_upsample`` over split rows: each stage's conv transpose
    re-split at its new rate (its crop included), the snake per frame, the
    resnet block with its halo and reductions."""
    mesh = x.mesh
    for i, (f, k) in enumerate(zip(cfg.wave_upsampler_factors, cfg.wave_upsampler_kernel_sizes)):
        pad = max(0, (k - f) // 2)
        x = seq.mask_rows(x, seq.replicate(frame_len, mesh))
        x = seq.conv_transpose(x, lambda r, p: conv_transpose1d(
            operand(p), operand(ws[r]["wave_upsampler"][i]["up_w"]),
            ws[r]["wave_upsampler"][i]["up_b"], stride=f), k, f, pad)
        frame_len = (frame_len - 1) * f + k - 2 * pad
        fl = seq.replicate(frame_len, mesh)
        x = seq.map_rows(x, lambda r, p, start: _snake_beta(
            mask_time(p, seq.local_lengths(fl[r], start, p.shape[1])),
            ws[r]["wave_upsampler"][i]["snake_alpha"], ws[r]["wave_upsampler"][i]["snake_beta"]))
        x = _sp_resnet_block(x, [w["wave_upsampler"][i]["resblk"] for w in ws], fl,
                             cfg.resnet_groups, cfg.group_norm_eps)
    fl = seq.replicate(frame_len, mesh)
    x = seq.map_rows(x, lambda r, p, start: mask_time(_snake_beta(
        mm(p, ws[r]["ups_out_proj_w"]) + ws[r]["ups_out_proj_b"], ws[r]["ups_out_snake_alpha"],
        ws[r]["ups_out_snake_beta"]), seq.local_lengths(fl[r], start, p.shape[1])))
    return x, frame_len


def _sp_decode_spec(cfg: MioCodecConfig, ws: list, tokens: torch.Tensor,
                    token_lengths: torch.Tensor, cond: torch.Tensor | None,
                    interp_anchor_tokens: int | None, mesh
                    ) -> tuple["seq.Sharded", torch.Tensor]:
    """``_codec_decode_spec`` with every time axis split over ``mesh``:
    (the spec split over its frames, frame_lengths [B] on the lead).
    ``tokens`` and the lengths may be on any device; the lengths are
    computed on the lead and copied to every rank."""
    check_supported(cfg)
    lead = mesh.lead
    tokens, token_lengths = tokens.to(lead), token_lengths.to(lead)
    B, N = tokens.shape
    stft_len = torch.clamp((token_lengths * cfg.samples_per_token) // cfg.hop_length, min=1)
    tf = cfg.wave_upsampler_total_factor
    dec_len = torch.clamp(stft_len // tf, min=1) if tf > 1 else stft_len
    F_dec = cfg.decoder_frames(N)
    tok_l = seq.replicate(token_lengths, mesh)
    dec_l = seq.replicate(dec_len, mesh)

    cond_act = [None] * mesh.devices.size
    if cfg.dynamic_global:
        c = cond.to(lead) if cond is not None else torch.zeros(
            (B, cfg.decoder_adanorm_dim), device=lead)
        cond_act = seq.replicate(F.silu(c.float()), mesh)

    def masked(lens, fn):
        return lambda r, p, start: mask_time(fn(r, p), seq.local_lengths(lens[r], start,
                                                                         p.shape[1]))

    x = seq.map_rows(seq.split(tokens, mesh),
                     masked(tok_l, lambda r, p: ws[r]["token_embd"][p.long()]))
    x = _sp_transformer_stack(x, [w["prenet_blocks"] for w in ws], cfg.prenet_heads, tok_l,
                              cfg.prenet_window, cfg.rope_theta, cfg.norm_eps, [None] * len(ws))
    x = seq.map_rows(x, masked(tok_l, lambda r, p: mm(
        layer_norm(p, ws[r]["prenet_norm_w"], ws[r]["prenet_norm_b"], eps=cfg.norm_eps),
        ws[r]["prenet_out_w"]) + ws[r]["prenet_out_b"]))

    K_up = ws[0]["upsample_w"].shape[-1]
    y = seq.conv_transpose(x, lambda r, p: conv_transpose1d(
        operand(p), operand(ws[r]["upsample_w"]), ws[r]["upsample_b"], stride=2), K_up, 2)
    src_l = seq.replicate((token_lengths - 1) * 2 + K_up, mesh)
    y = seq.mask_rows(y, src_l)
    scale_override = None
    if interp_anchor_tokens is not None:
        a = interp_anchor_tokens
        scale_override = ((a - 1) * 2 + K_up, cfg.decoder_frames(a))
    y = seq.mask_rows(seq.interpolate(y, src_l, dec_l, F_dec, scale_override), dec_l)

    if cfg.model_type == 0:
        for i in range(cfg.resnet_blocks):
            y = _sp_resnet_block(y, [{k: v[i] for k, v in w["prior"].items()} for w in ws], dec_l,
                                 cfg.resnet_groups, cfg.group_norm_eps)

    x = _sp_transformer_stack(y, [w["decoder_blocks"] for w in ws], cfg.decoder_heads, dec_l,
                              cfg.decoder_window, cfg.rope_theta, cfg.norm_eps, cond_act)
    if cfg.dynamic_global:
        dim = cfg.decoder_dim

        def final_norm(r, p, start):
            q = mm(cond_act[r], ws[r]["norm_cond_w"]) + ws[r]["norm_cond_b"]  # [B, 2*dim]
            return adaln_modulate(layer_norm(p, eps=cfg.norm_eps), q[:, :dim], q[:, dim:])
    else:
        def final_norm(r, p, start):
            return layer_norm(p, ws[r]["decoder_norm_w"], ws[r]["decoder_norm_b"],
                              eps=cfg.norm_eps)
    x = seq.map_rows(x, final_norm)

    frame_len = dec_len
    if cfg.model_type == 0:
        for i in range(cfg.resnet_blocks):
            x = _sp_resnet_block(seq.mask_rows(x, dec_l),
                                 [{k: v[i] for k, v in w["post"].items()} for w in ws], dec_l,
                                 cfg.resnet_groups, cfg.group_norm_eps)
        if cfg.wave_upsampler_factors:
            x, frame_len = _sp_wave_upsample(cfg, ws, x, frame_len)

    fl = seq.replicate(frame_len, mesh)
    spec = seq.map_rows(x, masked(fl, lambda r, p: mm(p, ws[r]["istft_out_w"])
                                  + ws[r]["istft_out_b"]))
    return spec, frame_len


def codec_synthesize_sharded(cfg: MioCodecConfig, w, tokens: torch.Tensor,
                             token_lengths: torch.Tensor, cond: torch.Tensor | None,
                             interp_anchor_tokens: int | None, peak_normalize: bool, sp_mesh, *,
                             matmul: str) -> tuple["seq.Sharded", torch.Tensor]:
    """``codec_synthesize`` over an ("sp",) mesh, the audio left split over
    its ranks (``seq.join`` makes it whole; a window of it is read by
    ``seq.gather_rows``): (audio, n_samples [B] on the lead). ``w`` is the
    weights, or one tree a rank. The kernels run on every rank: K1 in each
    attention layer, K4-K6 in the mel vocoder's stages."""
    ws = _rank_trees(w, sp_mesh)
    with codec_matmul(matmul):
        spec, frame_len = _sp_decode_spec(cfg, ws, tokens, token_lengths, cond,
                                          interp_anchor_tokens, sp_mesh)
        fl = seq.replicate(frame_len, sp_mesh)
        if cfg.model_type == 0:
            audio = seq.overlap_add(spec, fl, cfg.n_fft, cfg.hop_length,
                                    [t["istft_tables"] for t in ws])
            n_samples = istft_samples(cfg, frame_len)
        else:
            audio, n_samples = vocoder_decode_sp(cfg, ws, spec, fl)
    audio = seq.mask_rows(audio, seq.replicate(n_samples, sp_mesh))
    if peak_normalize:
        audio = seq.peak_normalize(audio)
    return audio, n_samples


def encode_global_embedding(cfg: MioCodecConfig, w: dict, ssl: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """SSL features -> speaker embedding: ConvNeXt backbone and attentive-
    stats pooling (miocodec-decoder.cpp:824-941). ssl [B, T, Cin], lengths
    [B] int32; returns [B, Cout], a row with a non-finite value replaced by
    zeros (:1048-1061)."""
    ge = w["global_encoder"]
    x = mask_time(ssl.float(), lengths)
    x = mask_time(conv1d_same(x, ge["embed_w"], ge["embed_b"]), lengths)  # k from the weight
    x = layer_norm(x, ge["norm_w"], ge["norm_b"], eps=1e-6)

    blocks = ge["blocks"]
    for i in range(blocks["dwconv_w"].shape[0]):
        blk = {k: v[i] for k, v in blocks.items()}
        y = conv1d_depthwise_same(mask_time(x, lengths), blk["dwconv_w"], blk["dwconv_b"])
        y = layer_norm(mask_time(y, lengths), blk["norm_w"], blk["norm_b"], eps=1e-6)
        y = F.gelu(y @ blk["pw1_w"] + blk["pw1_b"], approximate="tanh")  # ggml_gelu
        x = x + (y @ blk["pw2_w"] + blk["pw2_b"]) * blk["gamma"]

    x = mask_time(layer_norm(x, ge["final_norm_w"], ge["final_norm_b"], eps=1e-6), lengths)

    # attentive stats pooling: the k = 1 convs are linears; a softmax over
    # TIME for each channel, -inf on padding
    a = torch.tanh(x @ ge["pool_attn0_w"][:, :, 0].T + ge["pool_attn0_b"])
    a = a @ ge["pool_attn2_w"][:, :, 0].T + ge["pool_attn2_b"]
    a = a.masked_fill(~time_mask(x.shape[1], lengths)[:, :, None], float("-inf"))
    alpha = torch.softmax(a, dim=1)
    mean = (alpha * x).sum(dim=1)
    var = torch.clamp((alpha * x * x).sum(dim=1) - mean * mean, 1e-4, 1e4)
    stat = torch.cat([mean, torch.sqrt(var)], dim=-1)
    out = layer_norm(stat @ ge["pool_proj_w"] + ge["pool_proj_b"], ge["pool_norm_w"],
                     ge["pool_norm_b"], eps=1e-5)
    bad = (~torch.isfinite(out)).any(dim=-1, keepdim=True)
    return torch.where(bad, torch.zeros((), device=out.device), out)
