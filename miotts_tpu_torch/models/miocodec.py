"""MioCodec decoder, wave mode: audio codes -> STFT spectrogram -> waveform
(miotts_tpu/models/miocodec.py).

One batched, length-masked forward over [B, N] padded code batches. Every
convolution and group norm is length-masked, so a padded bucket computes
the unpadded math in its valid region. Codec math runs at f32 (the
reference accumulates attention in f32 and the fidelity bar is mel-L1 <
1e-2); ``device.select_device`` turns TF32 off on the card.

Weights are a plain dict of tensors with the JAX package's tree layout:
linear weights pre-transposed to [in, out], transformer and resnet blocks
stacked along a leading layer axis.

Not yet ported (each raises NotImplementedError): the wave upsampler
(ROADMAP M2.1), mel mode with its vocoder (ROADMAP M9) and the global
encoder (ROADMAP M8).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from miotts_tpu.gguf import GGUFReader

from ..ops.attention import banded_attention
from ..ops.convs import conv1d_same, conv_transpose1d, linear_interpolate
from ..ops.istft import dft_tables, spec_to_audio
from ..ops.masking import mask_time, time_mask
from ..ops.norms import adaln_modulate, layer_norm, masked_group_norm
from ..ops.rope import apply_rope


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
    """Raise for the codec variants the port does not run yet."""
    if cfg.model_type != 0:
        raise NotImplementedError("MioCodec mel mode is not yet ported to miotts_tpu_torch "
                                  "(ROADMAP M9)")
    if cfg.wave_upsampler_factors:
        raise NotImplementedError("the MioCodec wave upsampler is not yet ported to "
                                  "miotts_tpu_torch (ROADMAP M2.1)")


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


def to_device(tree: Any, device: torch.device) -> Any:
    """numpy leaves -> tensors on ``device`` (nested dicts, tuples, None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


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


def load_miocodec(path: str, device: torch.device) -> tuple[MioCodecConfig, dict]:
    """Load a wave-mode miocodec-dec GGUF onto ``device`` at f32."""
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
            "prior": _stack_blocks(get, cfg.resnet_blocks,
                                   _spec_with_prefix(_RESNET_SPEC, "wave_prior")),
            "post": _stack_blocks(get, cfg.resnet_blocks,
                                  _spec_with_prefix(_RESNET_SPEC, "wave_post")),
        }
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
        w["istft_tables"] = dft_tables(cfg.n_fft)
    return cfg, to_device(w, device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _transformer_stack(x, blocks: dict, n_heads: int, lengths, window: int, rope_theta: float,
                       norm_eps: float, cond_act) -> torch.Tensor:
    """Stacked transformer blocks over x [B, T, C]; ``cond_act`` [B, Dc]
    (SiLU-activated speaker embedding) turns on AdaLN-Zero conditioning."""
    B, T, C = x.shape
    positions = torch.arange(T, dtype=torch.int32, device=x.device)
    hd = C // n_heads
    for i in range(blocks["wq"].shape[0]):
        blk = {k: (v[i] if v is not None else None) for k, v in blocks.items()}
        if cond_act is not None:
            p = cond_act @ blk["attn_cond_w"] + blk["attn_cond_b"]  # [B, 3C]
            shift, scale, gate = p[:, :C], p[:, C:2 * C], p[:, 2 * C:]
            xn = adaln_modulate(layer_norm(x, eps=norm_eps), shift, scale)
        else:
            gate = None
            xn = layer_norm(x, blk["attn_norm_w"], blk["attn_norm_b"], eps=norm_eps)
        q = apply_rope((xn @ blk["wq"]).reshape(B, T, n_heads, hd), positions, rope_theta)
        k = apply_rope((xn @ blk["wk"]).reshape(B, T, n_heads, hd), positions, rope_theta)
        v = (xn @ blk["wv"]).reshape(B, T, n_heads, hd)
        att = banded_attention(q, k, v, lengths, window).reshape(B, T, C)
        out = att @ blk["wo"]
        if gate is not None:
            out = out * gate[:, None, :]
        h = x + out

        if cond_act is not None:
            p = cond_act @ blk["ffn_cond_w"] + blk["ffn_cond_b"]
            shift, scale, fgate = p[:, :C], p[:, C:2 * C], p[:, 2 * C:]
            fn = adaln_modulate(layer_norm(h, eps=norm_eps), shift, scale)
        else:
            fgate = None
            fn = layer_norm(h, blk["ffn_norm_w"], blk["ffn_norm_b"], eps=norm_eps)
        ff = (F.silu(fn @ blk["w1"]) * (fn @ blk["w3"])) @ blk["w2"]
        if fgate is not None:
            ff = ff * fgate[:, None, :]
        x = h + ff
    return x


def _resnet_block(x, blk: dict, lengths, groups: int, gn_eps: float) -> torch.Tensor:
    """GroupNorm/SiLU/conv residual block; re-masked after every bias so
    padded rows stay zero."""
    g = choose_num_groups(groups, x.shape[-1])

    def half(y, nw, nb, cw, cb):
        y = masked_group_norm(y, lengths, g, eps=gn_eps)
        y = F.silu(y * nw + nb)
        y = conv1d_same(mask_time(y, lengths), cw, cb)
        return mask_time(y, lengths)

    y = half(x, blk["norm1_w"], blk["norm1_b"], blk["conv1_w"], blk["conv1_b"])
    y = half(y, blk["norm2_w"], blk["norm2_b"], blk["conv2_w"], blk["conv2_b"])
    return x + y


def codec_decode_spec(cfg: MioCodecConfig, w: dict, tokens: torch.Tensor,
                      token_lengths: torch.Tensor, cond: torch.Tensor | None,
                      interp_anchor_tokens: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, N] codes (padded), token_lengths [B] int32, cond [B, Dc]
    speaker embedding or None (static models). Returns (spec [B, F, n_fft+2],
    frame_lengths [B]). ``interp_anchor_tokens`` pins the bilinear resize
    ratio to a fixed token count (None: the ratio from the true lengths)."""
    check_supported(cfg)
    B, N = tokens.shape
    dev = tokens.device
    stft_len = torch.clamp((token_lengths * cfg.samples_per_token) // cfg.hop_length, min=1)
    dec_len = stft_len
    F_dec = cfg.decoder_frames(N)

    cond_act = None
    if cfg.dynamic_global:
        c = cond if cond is not None else torch.zeros((B, cfg.decoder_adanorm_dim), device=dev)
        cond_act = F.silu(c.float())

    x = mask_time(w["token_embd"][tokens.long()], token_lengths)
    x = _transformer_stack(x, w["prenet_blocks"], cfg.prenet_heads, token_lengths,
                           cfg.prenet_window, cfg.rope_theta, cfg.norm_eps, None)
    x = layer_norm(x, w["prenet_norm_w"], w["prenet_norm_b"], eps=cfg.norm_eps)
    x = mask_time(x @ w["prenet_out_w"] + w["prenet_out_b"], token_lengths)

    K_up = w["upsample_w"].shape[-1]
    y = conv_transpose1d(x, w["upsample_w"], w["upsample_b"], stride=2)
    src_len = (token_lengths - 1) * 2 + K_up
    y = mask_time(y, src_len)
    scale_override = None
    if interp_anchor_tokens is not None:
        a = interp_anchor_tokens
        scale_override = ((a - 1) * 2 + K_up, cfg.decoder_frames(a))
    y = linear_interpolate(y, src_len, dec_len, F_dec, scale_override=scale_override)
    y = mask_time(y, dec_len)

    for i in range(cfg.resnet_blocks):
        y = _resnet_block(y, {k: v[i] for k, v in w["prior"].items()}, dec_len,
                          cfg.resnet_groups, cfg.group_norm_eps)

    x = _transformer_stack(y, w["decoder_blocks"], cfg.decoder_heads, dec_len,
                           cfg.decoder_window, cfg.rope_theta, cfg.norm_eps, cond_act)
    if cfg.dynamic_global:
        dim = cfg.decoder_dim
        p = cond_act @ w["norm_cond_w"] + w["norm_cond_b"]  # [B, 2*dim]
        x = adaln_modulate(layer_norm(x, eps=cfg.norm_eps), p[:, :dim], p[:, dim:])
    else:
        x = layer_norm(x, w["decoder_norm_w"], w["decoder_norm_b"], eps=cfg.norm_eps)

    for i in range(cfg.resnet_blocks):
        x = _resnet_block(mask_time(x, dec_len), {k: v[i] for k, v in w["post"].items()},
                          dec_len, cfg.resnet_groups, cfg.group_norm_eps)

    spec = mask_time(x @ w["istft_out_w"] + w["istft_out_b"], dec_len)
    return spec, dec_len


def codec_synthesize(cfg: MioCodecConfig, w: dict, tokens: torch.Tensor,
                     token_lengths: torch.Tensor, cond: torch.Tensor | None,
                     interp_anchor_tokens: int | None = None,
                     peak_normalize: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Codes -> waveform. Returns (audio [B, S_max], n_samples [B]); audio
    is peak-normalized per example like mio_tts_synthesize unless
    ``peak_normalize`` is False."""
    spec, frame_len = codec_decode_spec(cfg, w, tokens, token_lengths, cond,
                                        interp_anchor_tokens)
    audio = spec_to_audio(spec, frame_len, cfg.n_fft, cfg.hop_length, w["istft_tables"])
    n_pad = (cfg.n_fft - cfg.hop_length) // 2
    n_samples = (frame_len - 1) * cfg.hop_length + cfg.n_fft - 2 * n_pad
    audio = audio * time_mask(audio.shape[1], n_samples).to(audio.dtype)
    if peak_normalize:
        finite = torch.where(torch.isfinite(audio), audio, torch.zeros((), device=audio.device))
        peak = finite.abs().amax(dim=1)
        gain = torch.where(peak > 0.98, 0.95 / torch.clamp(peak, min=1e-9),
                           torch.ones((), device=audio.device))
        audio = audio * gain[:, None]
    return audio, n_samples


def encode_global_embedding(*_args, **_kwargs):
    """Reference audio -> speaker embedding (voice cloning)."""
    raise NotImplementedError("the MioCodec global encoder (voice cloning) is not yet "
                              "ported to miotts_tpu_torch (ROADMAP M8)")
