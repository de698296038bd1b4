"""MioCodec safetensors+config.yaml -> GGUF converter
(miotts_tpu/convert/miocodec.py, scripts/convert_miocodec_to_gguf.py).

Writes the same bytes as the JAX package's converter, through the port's
own GGUF writer. ``yaml`` and ``safetensors`` are imported only when a
checkpoint is converted, and ``torch`` only to read a ``.pt`` preset.

    python -m miotts_tpu_torch.converters.miocodec CODEC_DIR -o codec.gguf

Contract parity with the reference converter
(scripts/convert_miocodec_to_gguf.py): FSQ-decoded 12800-entry token table @
proj_out (:148-158,254-258), weight-norm fusion for conv/transposed-conv
(:188-194), dynamic-global (AdaLN tensors exported) vs static-preset (AdaLN
folded into affine norms + gated output projections, :272-303), wave
upsampler & mel postnet & global encoder & BigVGAN-style vocoder export.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np

from ..gguf.writer import GGUFWriter


def decode_fsq_indices(indices: np.ndarray, levels: list[int]) -> np.ndarray:
    """FSQ index -> normalized code vector in [-1, 1]^len(levels)."""
    levels_arr = np.asarray(levels, np.int64)
    basis = np.cumprod(np.asarray([1] + levels[:-1], np.int64))
    digits = (indices[:, None] // basis[None, :]) % levels_arr[None, :]
    half = (levels_arr // 2).astype(np.float32)
    return (digits.astype(np.float32) - half[None, :]) / half[None, :]


def weight_norm_fuse(g: np.ndarray, v: np.ndarray, dim: int = 0) -> np.ndarray:
    """torch weight_norm fusion. dim=0: per-output-channel norm over the
    rest; dim=2: norm over dims (0,1) (pos-conv convention)."""
    v = v.astype(np.float32)
    g = g.astype(np.float32)
    if dim == 0:
        norm = np.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(axis=1)).clip(min=1e-12)
        return v * (g.reshape(v.shape[0], 1, 1) / norm.reshape(-1, 1, 1))
    if dim == 2:
        norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True) + 1e-12)
        return v / norm * g
    raise ValueError(f"unsupported weight_norm dim {dim}")


def _silu(x: np.ndarray) -> np.ndarray:
    return x / (1.0 + np.exp(-x))


def _load_state(weights_path: Path) -> dict[str, np.ndarray]:
    from safetensors.numpy import load_file

    return {k: np.asarray(v) for k, v in load_file(str(weights_path)).items()}


def _load_embedding(path: Path) -> np.ndarray:
    suffix = path.suffix.lower()
    if suffix == ".pt":
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict):
            obj = obj.get("global_embedding", obj.get("embedding", obj))
        arr = obj.detach().cpu().float().numpy() if hasattr(obj, "detach") else np.asarray(obj)
    elif suffix == ".npz":
        z = np.load(path)
        for k in ("global_embedding", "embedding"):
            if k in z:
                arr = z[k]
                break
        else:
            arr = z[z.files[0]]
    else:
        raise ValueError(f"unsupported embedding format: {path}")
    arr = np.squeeze(np.asarray(arr, np.float32))
    if arr.ndim != 1:
        raise ValueError(f"global embedding must be 1D after squeeze, got {arr.shape}")
    return arr


def convert_miocodec(
    codec_config: str,
    codec_weights: str,
    outfile: str,
    dynamic_global: bool = True,
    preset_embedding: str = "",
    samples_per_token: int = 960,
    vocoder_upsample_rates: tuple[int, ...] = (8, 8, 2, 2, 2),
) -> dict:
    import yaml

    cfg_all = yaml.safe_load(Path(codec_config).read_text(encoding="utf-8"))
    init_args = cfg_all["model"]["init_args"]
    model_cfg = init_args["config"]

    use_wave = bool(model_cfg.get("use_wave_decoder", False))
    src_prenet = "wave_prenet" if use_wave else "mel_prenet"
    src_decoder = "wave_decoder" if use_wave else "mel_decoder"
    prenet_cfg = init_args[src_prenet]["init_args"]
    decoder_cfg = init_args[src_decoder]["init_args"]
    quantizer_cfg = init_args["local_quantizer"]["init_args"]
    ge_cfg = init_args["global_encoder"]["init_args"]

    state = _load_state(Path(codec_weights))
    global_embedding = _load_embedding(Path(preset_embedding)) if preset_embedding else None
    if not dynamic_global and global_embedding is None:
        raise ValueError("static-preset mode requires a preset embedding")

    levels = [int(x) for x in quantizer_cfg["levels"]]
    vocab = int(np.prod(levels))
    if vocab != 12800:
        raise ValueError(f"unexpected vocab size from levels {levels}: {vocab}")

    # token table: FSQ-decode all indices through proj_out
    fsq = decode_fsq_indices(np.arange(vocab, dtype=np.int64), levels)
    token_embd = (fsq @ state["local_quantizer.proj_out.weight"].astype(np.float32).T
                  + state["local_quantizer.proj_out.bias"].astype(np.float32)[None, :])

    n_dec = int(decoder_cfg["n_layers"])
    dec_dim = int(decoder_cfg["dim"])
    ada_dim = int(decoder_cfg["adanorm_condition_dim"])

    folded = {k: np.asarray(v, np.float32) for k, v in state.items()}
    static_norms: dict[str, np.ndarray] = {}
    if not dynamic_global:
        act = _silu(global_embedding.astype(np.float32))
        for i in range(n_dec):
            for tag, gated in (("attention_norm", f"{src_decoder}.layers.{i}.attention.wo.weight"),
                               ("ffn_norm", f"{src_decoder}.layers.{i}.feed_forward.w2.weight")):
                w = state[f"{src_decoder}.layers.{i}.{tag}.condition_proj.1.weight"].astype(np.float32)
                b = state[f"{src_decoder}.layers.{i}.{tag}.condition_proj.1.bias"].astype(np.float32)
                p = w @ act + b
                shift, scale, gate = np.split(p, 3)
                key = "attn" if tag == "attention_norm" else "ffn"
                static_norms[f"blk.{i}.{key}_norm.weight"] = 1.0 + scale
                static_norms[f"blk.{i}.{key}_norm.bias"] = shift
                folded[gated] = folded[gated] * gate[:, None]
        w = state[f"{src_decoder}.norm.condition_proj.1.weight"].astype(np.float32)
        b = state[f"{src_decoder}.norm.condition_proj.1.bias"].astype(np.float32)
        p = w @ act + b
        shift, scale = np.split(p, 2)
        static_norms["norm.weight"] = 1.0 + scale
        static_norms["norm.bias"] = shift

    ups_factors = [int(x) for x in (model_cfg.get("wave_upsampler_factors") or [])] if use_wave else []
    ups_kernels: list[int] = []
    if ups_factors:
        raw = model_cfg.get("wave_upsampler_kernel_sizes")
        ups_kernels = [int(x) for x in raw] if raw else [2 * f for f in ups_factors]
        if len(ups_kernels) != len(ups_factors):
            raise ValueError("wave_upsampler kernel/factor length mismatch")
    has_ups = bool(use_wave and ups_factors
                   and any(k.startswith("wave_upsampler.") for k in state))

    n_fft = int(model_cfg["n_fft"])
    n_mels = int(model_cfg.get("n_mels", 0))
    w = GGUFWriter(outfile, arch="miocodec-dec")
    w.add_string("general.type", "model")
    w.add_string("general.name", "MioCodec decoder (miotts_tpu)")
    w.add_uint32("miocodec.model_type", 0 if use_wave else 1)
    w.add_uint32("miocodec.dynamic_global", 1 if dynamic_global else 0)
    w.add_uint32("miocodec.sample_rate", int(model_cfg["sample_rate"]))
    w.add_uint32("miocodec.n_fft", n_fft)
    w.add_uint32("miocodec.hop_length", int(model_cfg["hop_length"]))
    w.add_uint32("miocodec.n_mels", n_mels)
    w.add_uint32("miocodec.samples_per_token", int(samples_per_token))
    w.add_uint32("miocodec.prenet_layers", int(prenet_cfg["n_layers"]))
    w.add_uint32("miocodec.prenet_dim", int(prenet_cfg["dim"]))
    w.add_uint32("miocodec.prenet_heads", int(prenet_cfg["n_heads"]))
    w.add_uint32("miocodec.prenet_ff",
                 int(state[f"{src_prenet}.layers.0.feed_forward.w1.weight"].shape[0]))
    w.add_uint32("miocodec.prenet_window", int(prenet_cfg["window_size"]))
    w.add_uint32("miocodec.decoder_layers", n_dec)
    w.add_uint32("miocodec.decoder_dim", dec_dim)
    w.add_uint32("miocodec.decoder_heads", int(decoder_cfg["n_heads"]))
    w.add_uint32("miocodec.decoder_ff",
                 int(state[f"{src_decoder}.layers.0.feed_forward.w1.weight"].shape[0]))
    w.add_uint32("miocodec.decoder_window", int(decoder_cfg["window_size"]))
    w.add_uint32("miocodec.decoder_adanorm_dim", ada_dim)
    w.add_uint32("miocodec.resnet_blocks",
                 int(model_cfg.get("wave_resnet_num_blocks", 0)) if use_wave else 0)
    w.add_uint32("miocodec.resnet_groups",
                 int(model_cfg.get("wave_resnet_num_groups", 1)) if use_wave else 1)
    w.add_uint32("miocodec.wave_upsampler_layers", len(ups_factors) if has_ups else 0)
    w.add_float32("miocodec.rope_theta", float(decoder_cfg.get("rope_theta", 10000.0)))
    w.add_float32("miocodec.norm_eps", float(decoder_cfg.get("norm_eps", 1e-5)))
    w.add_float32("miocodec.group_norm_eps", 1e-6)
    w.add_uint32("miocodec.global_encoder.input_channels", int(ge_cfg["input_channels"]))
    w.add_uint32("miocodec.global_encoder.output_channels", int(ge_cfg["output_channels"]))
    w.add_uint32("miocodec.global_encoder.dim", int(ge_cfg["dim"]))
    w.add_uint32("miocodec.global_encoder.intermediate_dim", int(ge_cfg["intermediate_dim"]))
    w.add_uint32("miocodec.global_encoder.num_layers", int(ge_cfg["num_layers"]))
    if has_ups:
        w.add_tensor("miocodec.wave_upsampler.factors", np.asarray(ups_factors, np.int32))
        w.add_tensor("miocodec.wave_upsampler.kernel_sizes", np.asarray(ups_kernels, np.int32))

    w.add_tensor("token_embd", token_embd.astype(np.float32))

    def add(dst: str, src: str) -> None:
        if src not in folded:
            raise KeyError(f"missing tensor in state: {src}")
        w.add_tensor(dst, folded[src].astype(np.float32))

    for i in range(int(prenet_cfg["n_layers"])):
        s = f"{src_prenet}.layers.{i}"
        add(f"wave_prenet.blk.{i}.attn_norm.weight", f"{s}.attention_norm.weight")
        add(f"wave_prenet.blk.{i}.attn_norm.bias", f"{s}.attention_norm.bias")
        add(f"wave_prenet.blk.{i}.attn_q.weight", f"{s}.attention.wq.weight")
        add(f"wave_prenet.blk.{i}.attn_k.weight", f"{s}.attention.wk.weight")
        add(f"wave_prenet.blk.{i}.attn_v.weight", f"{s}.attention.wv.weight")
        add(f"wave_prenet.blk.{i}.attn_output.weight", f"{s}.attention.wo.weight")
        add(f"wave_prenet.blk.{i}.ffn_norm.weight", f"{s}.ffn_norm.weight")
        add(f"wave_prenet.blk.{i}.ffn_norm.bias", f"{s}.ffn_norm.bias")
        add(f"wave_prenet.blk.{i}.ffn_gate.weight", f"{s}.feed_forward.w1.weight")
        add(f"wave_prenet.blk.{i}.ffn_down.weight", f"{s}.feed_forward.w2.weight")
        add(f"wave_prenet.blk.{i}.ffn_up.weight", f"{s}.feed_forward.w3.weight")
    add("wave_prenet.norm.weight", f"{src_prenet}.norm.weight")
    add("wave_prenet.norm.bias", f"{src_prenet}.norm.bias")
    add("wave_prenet.output.weight", f"{src_prenet}.output_proj.weight")
    add("wave_prenet.output.bias", f"{src_prenet}.output_proj.bias")

    up_key = "wave_conv_upsample" if use_wave else "mel_conv_upsample"
    add("wave_upsample.weight", f"{up_key}.weight")
    add("wave_upsample.bias", f"{up_key}.bias")

    def add_resnet(dst_prefix: str, src_prefix: str, n: int) -> None:
        for i in range(n):
            for name in ("norm1.weight", "norm1.bias", "conv1.weight", "conv1.bias",
                         "norm2.weight", "norm2.bias", "conv2.weight", "conv2.bias"):
                add(f"{dst_prefix}.{i}.{name}", f"{src_prefix}.blocks.{i}.{name}")

    n_res = int(model_cfg.get("wave_resnet_num_blocks", 0)) if use_wave else 0
    if use_wave:
        add_resnet("wave_prior", "wave_prior_net", n_res)

        if has_ups:
            for i in range(len(ups_factors)):
                up = f"wave_upsampler.upsample_layers.{i}"
                fusedw = weight_norm_fuse(
                    state[f"{up}.parametrizations.weight.original0"],
                    state[f"{up}.parametrizations.weight.original1"], dim=0)
                w.add_tensor(f"wave_upsampler.up.{i}.weight", fusedw)
                add(f"wave_upsampler.up.{i}.bias", f"{up}.bias")
                add(f"wave_upsampler.snake.{i}.alpha", f"wave_upsampler.snake_activations.{i}.alpha")
                add(f"wave_upsampler.snake.{i}.beta", f"wave_upsampler.snake_activations.{i}.beta")
                for name in ("norm1.weight", "norm1.bias", "conv1.weight", "conv1.bias",
                             "norm2.weight", "norm2.bias", "conv2.weight", "conv2.bias"):
                    add(f"wave_upsampler.resblk.{i}.{name}",
                        f"wave_upsampler.resnet_blocks.{i}.{name}")
            add("wave_upsampler.out_proj.weight", "wave_upsampler.out_proj.weight")
            add("wave_upsampler.out_proj.bias", "wave_upsampler.out_proj.bias")
            add("wave_upsampler.out_snake.alpha", "wave_upsampler.out_snake.alpha")
            add("wave_upsampler.out_snake.beta", "wave_upsampler.out_snake.beta")

    for i in range(n_dec):
        s = f"{src_decoder}.layers.{i}"
        if dynamic_global:
            add(f"wave_decoder.blk.{i}.attn_cond.weight", f"{s}.attention_norm.condition_proj.1.weight")
            add(f"wave_decoder.blk.{i}.attn_cond.bias", f"{s}.attention_norm.condition_proj.1.bias")
            add(f"wave_decoder.blk.{i}.ffn_cond.weight", f"{s}.ffn_norm.condition_proj.1.weight")
            add(f"wave_decoder.blk.{i}.ffn_cond.bias", f"{s}.ffn_norm.condition_proj.1.bias")
        else:
            w.add_tensor(f"wave_decoder.blk.{i}.attn_norm.weight", static_norms[f"blk.{i}.attn_norm.weight"])
            w.add_tensor(f"wave_decoder.blk.{i}.attn_norm.bias", static_norms[f"blk.{i}.attn_norm.bias"])
            w.add_tensor(f"wave_decoder.blk.{i}.ffn_norm.weight", static_norms[f"blk.{i}.ffn_norm.weight"])
            w.add_tensor(f"wave_decoder.blk.{i}.ffn_norm.bias", static_norms[f"blk.{i}.ffn_norm.bias"])
        add(f"wave_decoder.blk.{i}.attn_q.weight", f"{s}.attention.wq.weight")
        add(f"wave_decoder.blk.{i}.attn_k.weight", f"{s}.attention.wk.weight")
        add(f"wave_decoder.blk.{i}.attn_v.weight", f"{s}.attention.wv.weight")
        add(f"wave_decoder.blk.{i}.attn_output.weight", f"{s}.attention.wo.weight")
        add(f"wave_decoder.blk.{i}.ffn_gate.weight", f"{s}.feed_forward.w1.weight")
        add(f"wave_decoder.blk.{i}.ffn_down.weight", f"{s}.feed_forward.w2.weight")
        add(f"wave_decoder.blk.{i}.ffn_up.weight", f"{s}.feed_forward.w3.weight")

    if dynamic_global:
        add("wave_decoder.norm_cond.weight", f"{src_decoder}.norm.condition_proj.1.weight")
        add("wave_decoder.norm_cond.bias", f"{src_decoder}.norm.condition_proj.1.bias")
    else:
        w.add_tensor("wave_decoder.norm.weight", static_norms["norm.weight"])
        w.add_tensor("wave_decoder.norm.bias", static_norms["norm.bias"])

    if use_wave:
        add_resnet("wave_post", "wave_post_net", n_res)
        add("istft_head.out.weight", "istft_head.out.weight")
        add("istft_head.out.bias", "istft_head.out.bias")
    else:
        add("istft_head.out.weight", f"{src_decoder}.output_proj.weight")
        add("istft_head.out.bias", f"{src_decoder}.output_proj.bias")
        post_ids = sorted({
            int(m.group(1)) for k in state
            if (m := re.match(r"^mel_postnet\.convolutions\.(\d+)\.0\.weight$", k))
        })
        w.add_uint32("miocodec.mel_postnet_layers", len(post_ids))
        kernel = 0
        for i in post_ids:
            if kernel == 0:
                kernel = int(state[f"mel_postnet.convolutions.{i}.0.weight"].shape[-1])
            add(f"mel_postnet.{i}.conv.weight", f"mel_postnet.convolutions.{i}.0.weight")
            add(f"mel_postnet.{i}.conv.bias", f"mel_postnet.convolutions.{i}.0.bias")
            add(f"mel_postnet.{i}.norm.weight", f"mel_postnet.convolutions.{i}.1.norm.weight")
            add(f"mel_postnet.{i}.norm.bias", f"mel_postnet.convolutions.{i}.1.norm.bias")
        w.add_uint32("miocodec.mel_postnet_kernel_size", kernel)

    # global encoder
    add("global_encoder.backbone.embed.weight", "global_encoder.backbone.embed.weight")
    add("global_encoder.backbone.embed.bias", "global_encoder.backbone.embed.bias")
    add("global_encoder.backbone.norm.weight", "global_encoder.backbone.norm.weight")
    add("global_encoder.backbone.norm.bias", "global_encoder.backbone.norm.bias")
    add("global_encoder.backbone.final_norm.weight", "global_encoder.backbone.final_layer_norm.weight")
    add("global_encoder.backbone.final_norm.bias", "global_encoder.backbone.final_layer_norm.bias")
    for i in range(int(ge_cfg["num_layers"])):
        s = f"global_encoder.backbone.convnext.{i}"
        d = f"global_encoder.backbone.blk.{i}"
        add(f"{d}.dwconv.weight", f"{s}.dwconv.weight")
        add(f"{d}.dwconv.bias", f"{s}.dwconv.bias")
        add(f"{d}.norm.weight", f"{s}.norm.weight")
        add(f"{d}.norm.bias", f"{s}.norm.bias")
        add(f"{d}.pw1.weight", f"{s}.pwconv1.weight")
        add(f"{d}.pw1.bias", f"{s}.pwconv1.bias")
        add(f"{d}.pw2.weight", f"{s}.pwconv2.weight")
        add(f"{d}.pw2.bias", f"{s}.pwconv2.bias")
        add(f"{d}.gamma", f"{s}.gamma")
    add("global_encoder.pool.attn0.weight", "global_encoder.pooling.attn.0.weight")
    add("global_encoder.pool.attn0.bias", "global_encoder.pooling.attn.0.bias")
    add("global_encoder.pool.attn2.weight", "global_encoder.pooling.attn.2.weight")
    add("global_encoder.pool.attn2.bias", "global_encoder.pooling.attn.2.bias")
    add("global_encoder.pool.proj.weight", "global_encoder.pooling.proj.weight")
    add("global_encoder.pool.proj.bias", "global_encoder.pooling.proj.bias")
    add("global_encoder.pool.norm.weight", "global_encoder.pooling.norm.weight")
    add("global_encoder.pool.norm.bias", "global_encoder.pooling.norm.bias")

    # optional bundled vocoder (mel-mode)
    has_vocoder = any(k.startswith("vocoder.model.") for k in state)
    w.add_uint32("miocodec.has_vocoder", 1 if has_vocoder else 0)
    if has_vocoder:
        rates = list(vocoder_upsample_rates)
        num_ups = len(rates)
        rb_ids = sorted({
            int(m.group(1)) for k in state
            if (m := re.match(r"^vocoder\.model\.resblocks\.(\d+)\.convs1\.0\.weight_v$", k))
        })
        if not rb_ids:
            raise ValueError("vocoder tensors found but no resblocks detected")
        num_rb = max(rb_ids) + 1
        if num_rb % num_ups != 0:
            raise ValueError("num_resblocks not divisible by num_upsamples")
        w.add_uint32("miovocoder.sample_rate", int(model_cfg["sample_rate"]))
        w.add_uint32("miovocoder.n_mels", n_mels)
        w.add_uint32("miovocoder.num_upsamples", num_ups)
        w.add_uint32("miovocoder.num_kernels", num_rb // num_ups)
        w.add_tensor("miovocoder.upsample_rates", np.asarray(rates, np.int32))

        def add_wn_conv(dst: str, src: str, has_bias: bool) -> None:
            fusedw = weight_norm_fuse(state[f"{src}.weight_g"], state[f"{src}.weight_v"], dim=0)
            w.add_tensor(f"{dst}.weight", fusedw)
            if has_bias:
                add(f"{dst}.bias", f"{src}.bias")

        add_wn_conv("vocoder.conv_pre", "vocoder.model.conv_pre", True)
        add_wn_conv("vocoder.conv_post", "vocoder.model.conv_post", False)
        for i in range(num_ups):
            add_wn_conv(f"vocoder.ups.{i}.after", f"vocoder.model.ups.{i}.convolution_after", True)
            add_wn_conv(f"vocoder.ups.{i}.noise", f"vocoder.model.ups.{i}.convolution_noise", True)
        for r in range(num_rb):
            for c in range(3):
                add_wn_conv(f"vocoder.resblocks.{r}.convs1.{c}",
                            f"vocoder.model.resblocks.{r}.convs1.{c}", True)
                add_wn_conv(f"vocoder.resblocks.{r}.convs2.{c}",
                            f"vocoder.model.resblocks.{r}.convs2.{c}", True)
            for a in range(6):
                add(f"vocoder.resblocks.{r}.acts.{a}.alpha",
                    f"vocoder.model.resblocks.{r}.activations.{a}.act.alpha")
                add(f"vocoder.resblocks.{r}.acts.{a}.beta",
                    f"vocoder.model.resblocks.{r}.activations.{a}.act.beta")
                add(f"vocoder.resblocks.{r}.acts.{a}.up_filter",
                    f"vocoder.model.resblocks.{r}.activations.{a}.upsample.filter")
                add(f"vocoder.resblocks.{r}.acts.{a}.down_filter",
                    f"vocoder.model.resblocks.{r}.activations.{a}.downsample.lowpass.filter")
        add("vocoder.activation_post.alpha", "vocoder.model.activation_post.act.alpha")
        add("vocoder.activation_post.beta", "vocoder.model.activation_post.act.beta")
        add("vocoder.activation_post.up_filter", "vocoder.model.activation_post.upsample.filter")
        add("vocoder.activation_post.down_filter",
            "vocoder.model.activation_post.downsample.lowpass.filter")

    w.write()
    return {
        "outfile": str(Path(outfile).resolve()),
        "model_type": "wave" if use_wave else "mel",
        "dynamic_global_embedding": dynamic_global,
        "has_wave_upsampler": has_ups,
        "has_vocoder": has_vocoder,
        "vocab_size": vocab,
    }


def main(argv: list[str] | None = None) -> int:
    """scripts/convert_miocodec_to_gguf.py's command line. Default mode
    exports dynamic-global speaker conditioning; --static-preset-mode folds a
    preset embedding's AdaLN into fixed norms."""
    p = argparse.ArgumentParser(description="Convert MioCodec (safetensors + config.yaml) "
                                            "to GGUF.")
    p.add_argument("codec_dir", nargs="?", default="",
                   help="MioCodec directory with config.yaml + model.safetensors")
    p.add_argument("--codec-config", default="")
    p.add_argument("--codec-weights", default="")
    p.add_argument("--preset-embedding", default="",
                   help="required only with --static-preset-mode")
    p.add_argument("--dynamic-global-embedding", action="store_true",
                   help="export runtime-conditioning tensors (default mode)")
    p.add_argument("--static-preset-mode", action="store_true")
    p.add_argument("--samples-per-token", type=int, default=960)
    p.add_argument("--vocoder-upsample-rates", default="8,8,2,2,2")
    p.add_argument("-o", "--outfile", required=True)
    args = p.parse_args(argv)

    cfg = args.codec_config
    weights = args.codec_weights
    if args.codec_dir:
        d = Path(args.codec_dir)
        cfg = cfg or str(d / "config.yaml")
        weights = weights or str(d / "model.safetensors")
    if not cfg or not weights:
        p.error("set --codec-config and --codec-weights, or pass CODEC_DIR")

    dynamic = not args.static_preset_mode
    if not dynamic and not args.preset_embedding:
        p.error("--preset-embedding is required with --static-preset-mode")
    if dynamic and args.preset_embedding:
        print("warning: --preset-embedding is ignored in dynamic mode.", file=sys.stderr)

    summary = convert_miocodec(
        cfg, weights, args.outfile,
        dynamic_global=dynamic,
        preset_embedding=args.preset_embedding if not dynamic else "",
        samples_per_token=args.samples_per_token,
        vocoder_upsample_rates=tuple(
            int(x) for x in args.vocoder_upsample_rates.split(",") if x.strip()),
    )
    print(json.dumps(summary, ensure_ascii=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
