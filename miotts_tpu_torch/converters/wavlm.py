"""torchaudio WavLM Base+ checkpoint -> GGUF (first N transformer layers)
(miotts_tpu/convert/wavlm.py, scripts/convert_wavlm_base_plus_to_gguf.py).

Writes the same bytes as the JAX package's converter, through the port's
own GGUF writer.

    python -m miotts_tpu_torch.converters.wavlm --wavlm-weights wavlm_base_plus.pth -o wavlm.gguf

Contract parity with scripts/convert_wavlm_base_plus_to_gguf.py: pos-conv
weight-norm fusion over dims (0,1) (dim=2 convention, :82-87), fixed Base+
conv stack geometry, tensor names as loaded by wavlm-extractor.cpp:498-538.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..gguf.writer import GGUFWriter

CONV_KERNELS = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDES = (5, 2, 2, 2, 2, 2, 2)


def fuse_pos_conv_weight(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    norm = np.sqrt((v.astype(np.float32) ** 2).sum(axis=(0, 1), keepdims=True) + 1e-12)
    return v.astype(np.float32) / norm * g.astype(np.float32)


def convert_wavlm(wavlm_weights: str, outfile: str,
                  num_transformer_layers: int = 2, sample_rate: int = 16000) -> dict:
    import torch

    obj = torch.load(wavlm_weights, map_location="cpu", weights_only=True)
    sd_t = obj["model"] if isinstance(obj, dict) and isinstance(obj.get("model"), dict) else obj
    sd = {k: v.detach().cpu().float().numpy() for k, v in sd_t.items()}

    avail = 0
    while f"encoder.transformer.layers.{avail}.attention.attention.in_proj_weight" in sd:
        avail += 1
    if avail == 0:
        raise ValueError("unable to find transformer layer weights in WavLM checkpoint")
    n_layers = num_transformer_layers
    if not (1 <= n_layers <= avail):
        raise ValueError(f"num_transformer_layers must be in [1, {avail}], got {n_layers}")

    w = GGUFWriter(outfile, arch="wavlm-ssl")
    w.add_string("general.type", "model")
    w.add_string("general.name",
                 f"WavLM Base+ (first {n_layers} layers) for MioTTS reference conditioning")
    w.add_uint32("wavlm.sample_rate", sample_rate)
    w.add_uint32("wavlm.n_layers", n_layers)
    w.add_uint32("wavlm.n_heads", 12)
    w.add_uint32("wavlm.head_dim", 64)
    w.add_uint32("wavlm.embed_dim", 768)
    w.add_uint32("wavlm.num_buckets", 320)
    w.add_uint32("wavlm.max_distance", 800)
    w.add_float32("wavlm.layer_norm_eps", 1e-5)
    for i, (k, s) in enumerate(zip(CONV_KERNELS, CONV_STRIDES)):
        w.add_uint32(f"wavlm.feat.conv{i}.kernel", k)
        w.add_uint32(f"wavlm.feat.conv{i}.stride", s)

    def add(dst: str, src: str) -> None:
        if src not in sd:
            raise KeyError(f"missing tensor in checkpoint: {src}")
        w.add_tensor(dst, sd[src])

    add("wavlm.feat.conv0.norm.weight", "feature_extractor.conv_layers.0.layer_norm.weight")
    add("wavlm.feat.conv0.norm.bias", "feature_extractor.conv_layers.0.layer_norm.bias")
    for i in range(7):
        add(f"wavlm.feat.conv{i}.weight", f"feature_extractor.conv_layers.{i}.conv.weight")
    add("wavlm.proj.norm.weight", "encoder.feature_projection.layer_norm.weight")
    add("wavlm.proj.norm.bias", "encoder.feature_projection.layer_norm.bias")
    add("wavlm.proj.weight", "encoder.feature_projection.projection.weight")
    add("wavlm.proj.bias", "encoder.feature_projection.projection.bias")
    add("wavlm.transformer.norm.weight", "encoder.transformer.layer_norm.weight")
    add("wavlm.transformer.norm.bias", "encoder.transformer.layer_norm.bias")
    w.add_tensor("wavlm.pos_conv.weight", fuse_pos_conv_weight(
        sd["encoder.transformer.pos_conv_embed.conv.weight_v"],
        sd["encoder.transformer.pos_conv_embed.conv.weight_g"]))
    add("wavlm.pos_conv.bias", "encoder.transformer.pos_conv_embed.conv.bias")

    for i in range(n_layers):
        s = f"encoder.transformer.layers.{i}"
        d = f"wavlm.layer.{i}"
        add(f"{d}.attn.in_proj.weight", f"{s}.attention.attention.in_proj_weight")
        add(f"{d}.attn.in_proj.bias", f"{s}.attention.attention.in_proj_bias")
        add(f"{d}.attn.out_proj.weight", f"{s}.attention.attention.out_proj.weight")
        add(f"{d}.attn.out_proj.bias", f"{s}.attention.attention.out_proj.bias")
        add(f"{d}.attn.gru.weight", f"{s}.attention.gru_rel_pos_linear.weight")
        add(f"{d}.attn.gru.bias", f"{s}.attention.gru_rel_pos_linear.bias")
        add(f"{d}.attn.gru_const", f"{s}.attention.gru_rel_pos_const")
        add(f"{d}.norm1.weight", f"{s}.layer_norm.weight")
        add(f"{d}.norm1.bias", f"{s}.layer_norm.bias")
        add(f"{d}.ffn.w1.weight", f"{s}.feed_forward.intermediate_dense.weight")
        add(f"{d}.ffn.w1.bias", f"{s}.feed_forward.intermediate_dense.bias")
        add(f"{d}.ffn.w2.weight", f"{s}.feed_forward.output_dense.weight")
        add(f"{d}.ffn.w2.bias", f"{s}.feed_forward.output_dense.bias")
        add(f"{d}.norm2.weight", f"{s}.final_layer_norm.weight")
        add(f"{d}.norm2.bias", f"{s}.final_layer_norm.bias")

    if "encoder.transformer.layers.0.attention.rel_attn_embed.weight" in sd:
        add("wavlm.layer.0.attn.rel_embed.weight",
            "encoder.transformer.layers.0.attention.rel_attn_embed.weight")

    w.write()
    return {"outfile": str(Path(outfile).resolve()),
            "n_layers": n_layers, "sample_rate": sample_rate}


def main(argv: list[str] | None = None) -> int:
    """scripts/convert_wavlm_base_plus_to_gguf.py's command line."""
    p = argparse.ArgumentParser(description="Convert torchaudio WavLM Base+ "
                                            "(wavlm_base_plus.pth) to GGUF.")
    p.add_argument("--wavlm-weights", required=True)
    p.add_argument("--num-transformer-layers", type=int, default=2)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("-o", "--outfile", required=True)
    args = p.parse_args(argv)
    print(json.dumps(convert_wavlm(args.wavlm_weights, args.outfile,
                                   args.num_transformer_layers, args.sample_rate)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
