"""Synthetic model assets without JAX (miotts_tpu/testing.py:20-311).

No model weights ship with the repo, so tests and ``chip_smoke.py`` write
GGUFs with the converter's tensor names and shapes and random weights from
a seed. These writers draw the same random numbers in the same order as
``miotts_tpu.testing``, so for the same seed both write the same tensors;
they exist because ``miotts_tpu.testing`` imports JAX. The speaker
embedding writer and the mel-L1 fidelity metric are the JAX package's own
jax-free host code, re-exported here.
"""

from __future__ import annotations

import numpy as np

from miotts_tpu.gguf.writer import GGUFWriter, save_embedding_gguf  # noqa: F401 (re-export)
from miotts_tpu.runtime.metrics import mel_l1  # noqa: F401 (re-export)
from miotts_tpu.runtime.tokenizer import (
    TOKEN_TYPE_CONTROL, TOKEN_TYPE_NORMAL, _bytes_to_unicode,
)

from .models.miocodec import MioCodecConfig


def tiny_codec_config(**overrides) -> MioCodecConfig:
    base = dict(
        model_type=0, sample_rate=24000, n_fft=64, hop_length=16, n_mels=0,
        samples_per_token=32,
        prenet_layers=2, prenet_dim=64, prenet_heads=4, prenet_ff=96, prenet_window=9,
        decoder_layers=2, decoder_dim=32, decoder_heads=4, decoder_ff=48,
        decoder_window=9, decoder_adanorm_dim=16,
        resnet_blocks=2, resnet_groups=32,
        rope_theta=10000.0, norm_eps=1e-5, group_norm_eps=1e-6,
        dynamic_global=True,
        global_encoder_input_channels=24, global_encoder_output_channels=16,
        global_encoder_dim=20, global_encoder_intermediate_dim=40,
        global_encoder_layers=2,
        vocab_size=128,
    )
    base.update(overrides)
    return MioCodecConfig(**base)


def full_codec_config(**overrides) -> MioCodecConfig:
    """Production-scale config (matches the shipped 24 kHz MioCodec,
    miocodec-decoder.h:12-48)."""
    base = dict(dynamic_global=True)
    base.update(overrides)
    return MioCodecConfig(**base)


def write_synthetic_miocodec_gguf(path: str, cfg: MioCodecConfig, seed: int = 0,
                                  with_global_encoder: bool = True) -> None:
    rng = np.random.RandomState(seed)

    def rnd(*shape, scale=None):
        if scale is None:
            fan_in = shape[-1] if len(shape) >= 2 else shape[0]
            scale = 1.0 / np.sqrt(max(1, fan_in))
        return (rng.randn(*shape) * scale).astype(np.float32)

    w = GGUFWriter(path, arch="miocodec-dec")
    w.add_string("general.type", "model")
    w.add_string("general.name", "synthetic miocodec")
    w.add_uint32("miocodec.model_type", cfg.model_type)
    w.add_uint32("miocodec.dynamic_global", 1 if cfg.dynamic_global else 0)
    w.add_uint32("miocodec.sample_rate", cfg.sample_rate)
    w.add_uint32("miocodec.n_fft", cfg.n_fft)
    w.add_uint32("miocodec.hop_length", cfg.hop_length)
    w.add_uint32("miocodec.n_mels", cfg.n_mels)
    w.add_uint32("miocodec.samples_per_token", cfg.samples_per_token)
    w.add_uint32("miocodec.prenet_layers", cfg.prenet_layers)
    w.add_uint32("miocodec.prenet_dim", cfg.prenet_dim)
    w.add_uint32("miocodec.prenet_heads", cfg.prenet_heads)
    w.add_uint32("miocodec.prenet_ff", cfg.prenet_ff)
    w.add_uint32("miocodec.prenet_window", cfg.prenet_window)
    w.add_uint32("miocodec.decoder_layers", cfg.decoder_layers)
    w.add_uint32("miocodec.decoder_dim", cfg.decoder_dim)
    w.add_uint32("miocodec.decoder_heads", cfg.decoder_heads)
    w.add_uint32("miocodec.decoder_ff", cfg.decoder_ff)
    w.add_uint32("miocodec.decoder_window", cfg.decoder_window)
    w.add_uint32("miocodec.decoder_adanorm_dim", cfg.decoder_adanorm_dim)
    w.add_uint32("miocodec.resnet_blocks", cfg.resnet_blocks)
    w.add_uint32("miocodec.resnet_groups", cfg.resnet_groups)
    w.add_uint32("miocodec.wave_upsampler_layers", len(cfg.wave_upsampler_factors))
    w.add_float32("miocodec.rope_theta", cfg.rope_theta)
    w.add_float32("miocodec.norm_eps", cfg.norm_eps)
    w.add_float32("miocodec.group_norm_eps", cfg.group_norm_eps)
    w.add_uint32("miocodec.has_vocoder", 0)
    w.add_uint32("miocodec.global_encoder.input_channels", cfg.global_encoder_input_channels)
    w.add_uint32("miocodec.global_encoder.output_channels", cfg.global_encoder_output_channels)
    w.add_uint32("miocodec.global_encoder.dim", cfg.global_encoder_dim)
    w.add_uint32("miocodec.global_encoder.intermediate_dim", cfg.global_encoder_intermediate_dim)
    w.add_uint32("miocodec.global_encoder.num_layers", cfg.global_encoder_layers)

    if cfg.wave_upsampler_factors:
        w.add_tensor("miocodec.wave_upsampler.factors",
                     np.asarray(cfg.wave_upsampler_factors, np.int32))
        w.add_tensor("miocodec.wave_upsampler.kernel_sizes",
                     np.asarray(cfg.wave_upsampler_kernel_sizes, np.int32))

    pd, dd = cfg.prenet_dim, cfg.decoder_dim
    w.add_tensor("token_embd", rnd(cfg.vocab_size, pd, scale=0.5))

    def transformer(prefix, n, dim, ff, cond_dim=None):
        for i in range(n):
            p = f"{prefix}.blk.{i}"
            if cond_dim is None:
                w.add_tensor(f"{p}.attn_norm.weight", 1.0 + rnd(dim, scale=0.05))
                w.add_tensor(f"{p}.attn_norm.bias", rnd(dim, scale=0.05))
                w.add_tensor(f"{p}.ffn_norm.weight", 1.0 + rnd(dim, scale=0.05))
                w.add_tensor(f"{p}.ffn_norm.bias", rnd(dim, scale=0.05))
            else:
                w.add_tensor(f"{p}.attn_cond.weight", rnd(3 * dim, cond_dim, scale=0.1))
                w.add_tensor(f"{p}.attn_cond.bias", rnd(3 * dim, scale=0.1))
                w.add_tensor(f"{p}.ffn_cond.weight", rnd(3 * dim, cond_dim, scale=0.1))
                w.add_tensor(f"{p}.ffn_cond.bias", rnd(3 * dim, scale=0.1))
            for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
                w.add_tensor(f"{p}.{nm}.weight", rnd(dim, dim))
            w.add_tensor(f"{p}.ffn_gate.weight", rnd(ff, dim))
            w.add_tensor(f"{p}.ffn_down.weight", rnd(dim, ff))
            w.add_tensor(f"{p}.ffn_up.weight", rnd(ff, dim))

    transformer("wave_prenet", cfg.prenet_layers, pd, cfg.prenet_ff)
    w.add_tensor("wave_prenet.norm.weight", 1.0 + rnd(pd, scale=0.05))
    w.add_tensor("wave_prenet.norm.bias", rnd(pd, scale=0.05))
    w.add_tensor("wave_prenet.output.weight", rnd(dd, pd))
    w.add_tensor("wave_prenet.output.bias", rnd(dd, scale=0.05))
    w.add_tensor("wave_upsample.weight", rnd(dd, dd, 4))  # ConvTranspose1d [in,out,k]
    w.add_tensor("wave_upsample.bias", rnd(dd, scale=0.05))

    def resnet(prefix, n, ch, k=3):
        for i in range(n):
            p = f"{prefix}.{i}"
            w.add_tensor(f"{p}.norm1.weight", 1.0 + rnd(ch, scale=0.05))
            w.add_tensor(f"{p}.norm1.bias", rnd(ch, scale=0.05))
            w.add_tensor(f"{p}.conv1.weight", rnd(ch, ch, k))
            w.add_tensor(f"{p}.conv1.bias", rnd(ch, scale=0.05))
            w.add_tensor(f"{p}.norm2.weight", 1.0 + rnd(ch, scale=0.05))
            w.add_tensor(f"{p}.norm2.bias", rnd(ch, scale=0.05))
            w.add_tensor(f"{p}.conv2.weight", rnd(ch, ch, k))
            w.add_tensor(f"{p}.conv2.bias", rnd(ch, scale=0.05))

    if cfg.model_type == 0:
        resnet("wave_prior", cfg.resnet_blocks, dd)
        resnet("wave_post", cfg.resnet_blocks, dd)

    transformer("wave_decoder", cfg.decoder_layers, dd, cfg.decoder_ff,
                cond_dim=cfg.decoder_adanorm_dim if cfg.dynamic_global else None)
    if cfg.dynamic_global:
        w.add_tensor("wave_decoder.norm_cond.weight", rnd(2 * dd, cfg.decoder_adanorm_dim, scale=0.1))
        w.add_tensor("wave_decoder.norm_cond.bias", rnd(2 * dd, scale=0.1))
    else:
        w.add_tensor("wave_decoder.norm.weight", 1.0 + rnd(dd, scale=0.05))
        w.add_tensor("wave_decoder.norm.bias", rnd(dd, scale=0.05))

    ch_final = dd
    if cfg.wave_upsampler_factors:
        for i, (f, k) in enumerate(zip(cfg.wave_upsampler_factors, cfg.wave_upsampler_kernel_sizes)):
            w.add_tensor(f"wave_upsampler.up.{i}.weight", rnd(ch_final, ch_final, k))
            w.add_tensor(f"wave_upsampler.up.{i}.bias", rnd(ch_final, scale=0.05))
            w.add_tensor(f"wave_upsampler.snake.{i}.alpha", rnd(ch_final, scale=0.1))
            w.add_tensor(f"wave_upsampler.snake.{i}.beta", rnd(ch_final, scale=0.1))
            p = f"wave_upsampler.resblk.{i}"
            w.add_tensor(f"{p}.norm1.weight", 1.0 + rnd(ch_final, scale=0.05))
            w.add_tensor(f"{p}.norm1.bias", rnd(ch_final, scale=0.05))
            w.add_tensor(f"{p}.conv1.weight", rnd(ch_final, ch_final, 3))
            w.add_tensor(f"{p}.conv1.bias", rnd(ch_final, scale=0.05))
            w.add_tensor(f"{p}.norm2.weight", 1.0 + rnd(ch_final, scale=0.05))
            w.add_tensor(f"{p}.norm2.bias", rnd(ch_final, scale=0.05))
            w.add_tensor(f"{p}.conv2.weight", rnd(ch_final, ch_final, 3))
            w.add_tensor(f"{p}.conv2.bias", rnd(ch_final, scale=0.05))
        w.add_tensor("wave_upsampler.out_proj.weight", rnd(ch_final, ch_final))
        w.add_tensor("wave_upsampler.out_proj.bias", rnd(ch_final, scale=0.05))
        w.add_tensor("wave_upsampler.out_snake.alpha", rnd(ch_final, scale=0.1))
        w.add_tensor("wave_upsampler.out_snake.beta", rnd(ch_final, scale=0.1))

    bins = (cfg.n_fft + 2) if cfg.model_type == 0 else cfg.n_mels
    # keep logmag small so exp() stays tame
    w.add_tensor("istft_head.out.weight", rnd(bins, ch_final, scale=0.02))
    w.add_tensor("istft_head.out.bias", rnd(bins, scale=0.02))

    if with_global_encoder:
        gd, gi = cfg.global_encoder_dim, cfg.global_encoder_intermediate_dim
        gin, gout = cfg.global_encoder_input_channels, cfg.global_encoder_output_channels
        w.add_tensor("global_encoder.backbone.embed.weight", rnd(gd, gin, 7))
        w.add_tensor("global_encoder.backbone.embed.bias", rnd(gd, scale=0.05))
        w.add_tensor("global_encoder.backbone.norm.weight", 1.0 + rnd(gd, scale=0.05))
        w.add_tensor("global_encoder.backbone.norm.bias", rnd(gd, scale=0.05))
        for i in range(cfg.global_encoder_layers):
            p = f"global_encoder.backbone.blk.{i}"
            w.add_tensor(f"{p}.dwconv.weight", rnd(gd, 1, 7))
            w.add_tensor(f"{p}.dwconv.bias", rnd(gd, scale=0.05))
            w.add_tensor(f"{p}.norm.weight", 1.0 + rnd(gd, scale=0.05))
            w.add_tensor(f"{p}.norm.bias", rnd(gd, scale=0.05))
            w.add_tensor(f"{p}.pw1.weight", rnd(gi, gd))
            w.add_tensor(f"{p}.pw1.bias", rnd(gi, scale=0.05))
            w.add_tensor(f"{p}.pw2.weight", rnd(gd, gi))
            w.add_tensor(f"{p}.pw2.bias", rnd(gd, scale=0.05))
            w.add_tensor(f"{p}.gamma", rnd(gd, scale=0.3))
        w.add_tensor("global_encoder.backbone.final_norm.weight", 1.0 + rnd(gd, scale=0.05))
        w.add_tensor("global_encoder.backbone.final_norm.bias", rnd(gd, scale=0.05))
        w.add_tensor("global_encoder.pool.attn0.weight", rnd(gd, gd, 1))
        w.add_tensor("global_encoder.pool.attn0.bias", rnd(gd, scale=0.05))
        w.add_tensor("global_encoder.pool.attn2.weight", rnd(gd, gd, 1))
        w.add_tensor("global_encoder.pool.attn2.bias", rnd(gd, scale=0.05))
        w.add_tensor("global_encoder.pool.proj.weight", rnd(gout, 2 * gd))
        w.add_tensor("global_encoder.pool.proj.bias", rnd(gout, scale=0.05))
        w.add_tensor("global_encoder.pool.norm.weight", 1.0 + rnd(gout, scale=0.05))
        w.add_tensor("global_encoder.pool.norm.bias", rnd(gout, scale=0.05))

    w.write()


# ---------------------------------------------------------------------------
# Synthetic LLM GGUF (qwen2-convention) for tests/benchmarks
# ---------------------------------------------------------------------------

def synthetic_vocab(n_audio: int = 64, n_filler: int = 0) -> tuple[list[str], list[int]]:
    """Byte-level vocab + chat specials + <|s_N|> audio tokens (+ optional
    filler tokens to reach a realistic vocab size, e.g. ~152k for the
    production MioTTS LLM)."""
    byte_chars = list(_bytes_to_unicode().values())
    tokens = byte_chars[:]
    types = [TOKEN_TYPE_NORMAL] * len(tokens)
    specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    tokens += specials
    types += [TOKEN_TYPE_CONTROL] * len(specials)
    for i in range(n_audio):
        tokens.append(f"<|s_{i}|>")
        types.append(TOKEN_TYPE_CONTROL)
    for i in range(n_filler):
        tokens.append(f"<filler_{i}>")
        types.append(TOKEN_TYPE_NORMAL)
    return tokens, types


def write_synthetic_llm_gguf(
    path: str,
    n_audio: int = 64,
    dim: int = 32,
    n_layers: int = 2,
    n_heads: int = 4,
    n_kv_heads: int = 2,
    ffn: int = 64,
    seed: int = 0,
    arch: str = "qwen2",
    n_filler_vocab: int = 0,
    audio_logit_scale: float = 1.0,
    quant: str = "f32",
) -> None:
    """``audio_logit_scale > 1`` scales the output-head rows of the
    ``<|s_N|>`` audio tokens so sampled generations are code-dense like the
    real MioTTS model (whose outputs are nearly all audio codes). With
    random weights only ~n_audio/vocab of samples are codes, which makes
    streaming/TTFA benchmarks unrepresentative (the first-audio feed
    threshold is rarely reached mid-generation); a scale of 3 makes the
    top-k all-audio at production vocab sizes."""
    rng = np.random.RandomState(seed)
    tokens, types = synthetic_vocab(n_audio, n_filler_vocab)
    vocab = len(tokens)
    head_dim = dim // n_heads
    audio_lo = len(tokens) - n_audio - n_filler_vocab
    audio_hi = audio_lo + n_audio

    def rnd(*shape):
        fan_in = shape[-1] if len(shape) >= 2 else shape[0]
        return (rng.randn(*shape) / np.sqrt(max(1, fan_in))).astype(np.float32)

    w = GGUFWriter(path, arch=arch)
    w.add_string("general.type", "model")
    w.add_string("general.name", "synthetic miotts llm")
    w.add_uint32(f"{arch}.block_count", n_layers)
    w.add_uint32(f"{arch}.embedding_length", dim)
    w.add_uint32(f"{arch}.attention.head_count", n_heads)
    w.add_uint32(f"{arch}.attention.head_count_kv", n_kv_heads)
    w.add_uint32(f"{arch}.feed_forward_length", ffn)
    w.add_float32(f"{arch}.attention.layer_norm_rms_epsilon", 1e-6)
    w.add_float32(f"{arch}.rope.freq_base", 10000.0)
    w.add_uint32(f"{arch}.context_length", 2048)
    w.add_string("tokenizer.ggml.model", "gpt2")
    w.add_array_str("tokenizer.ggml.tokens", tokens)
    w.add_array_i32("tokenizer.ggml.token_type", types)
    w.add_array_str("tokenizer.ggml.merges", [])
    w.add_uint32("tokenizer.ggml.eos_token_id", tokens.index("<|im_end|>"))
    w.add_uint32("tokenizer.ggml.bos_token_id", tokens.index("<|endoftext|>"))
    w.add_bool("tokenizer.ggml.add_bos_token", False)

    # quant="q8_0"/"q4_0": matmul weights as quant block payloads (the
    # shipped MioTTS-0.1B-Q8_0 storage, or a llama.cpp 4-bit export) — the
    # native CPU engine then loads without a quantization pass, like a real
    # download
    mm = {"q8_0": w.add_tensor_q8_0,
          "q4_0": w.add_tensor_q4_0,
          "f16": lambda n, a: w.add_tensor(n, a.astype(np.float16)),
          }.get(quant, w.add_tensor)
    w.add_tensor("token_embd.weight", rnd(vocab, dim))
    for i in range(n_layers):
        w.add_tensor(f"blk.{i}.attn_norm.weight", 1.0 + rnd(dim) * 0.05)
        mm(f"blk.{i}.attn_q.weight", rnd(n_heads * head_dim, dim))
        w.add_tensor(f"blk.{i}.attn_q.bias", rnd(n_heads * head_dim) * 0.05)
        mm(f"blk.{i}.attn_k.weight", rnd(n_kv_heads * head_dim, dim))
        w.add_tensor(f"blk.{i}.attn_k.bias", rnd(n_kv_heads * head_dim) * 0.05)
        mm(f"blk.{i}.attn_v.weight", rnd(n_kv_heads * head_dim, dim))
        w.add_tensor(f"blk.{i}.attn_v.bias", rnd(n_kv_heads * head_dim) * 0.05)
        mm(f"blk.{i}.attn_output.weight", rnd(dim, n_heads * head_dim))
        w.add_tensor(f"blk.{i}.ffn_norm.weight", 1.0 + rnd(dim) * 0.05)
        mm(f"blk.{i}.ffn_gate.weight", rnd(ffn, dim))
        mm(f"blk.{i}.ffn_up.weight", rnd(ffn, dim))
        mm(f"blk.{i}.ffn_down.weight", rnd(dim, ffn))
    w.add_tensor("output_norm.weight", 1.0 + rnd(dim) * 0.05)
    out_w = rnd(vocab, dim)
    if audio_logit_scale != 1.0:
        out_w[audio_lo:audio_hi] *= np.float32(audio_logit_scale)
    mm("output.weight", out_w)
    w.write()
