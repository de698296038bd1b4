"""Turn the JAX package's parameter trees into the port's.

Both take the tree as ``miotts_tpu`` builds it (``load_miocodec`` /
``load_llm_gguf`` / ``load_wavlm``), with numpy (or any array convertible by
``np.asarray``) leaves, so tests can run both packages on the same
in-memory weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.llm import LLMConfig, weights_to_device
from .models.miocodec import MioCodecConfig, check_supported
from .models.wavlm import WavLMConfig
from .ops.istft import hann_periodic
from .runtime.device_dequant import tree_to_device

_CODEC_KEYS = ("token_embd", "prenet_blocks", "prenet_norm_w", "prenet_norm_b",
               "prenet_out_w", "prenet_out_b", "upsample_w", "upsample_b", "prior", "post",
               "decoder_blocks", "norm_cond_w", "norm_cond_b", "decoder_norm_w",
               "decoder_norm_b", "istft_out_w", "istft_out_b", "istft_tables", "mel_postnet",
               "vocoder", "wave_upsampler", "ups_out_proj_w", "ups_out_proj_b",
               "ups_out_snake_alpha", "ups_out_snake_beta", "global_encoder")


def _f32(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_f32(v) for v in tree)
    return np.array(tree, dtype=np.float32)  # a writable copy for torch.from_numpy


def miocodec_params_from_jax(cfg, tree: dict, device: torch.device
                             ) -> tuple[MioCodecConfig, dict]:
    """JAX MioCodec (config, weight tree) -> the port's, at f32 on
    ``device``, the global encoder's subtree among them. The JAX tree's iSTFT tables are the two DFT matrices; the port's also
    hold the Hann window (``ops/istft.py dft_tables``)."""
    pcfg = MioCodecConfig(**dataclasses.asdict(cfg))
    check_supported(pcfg)
    w = {k: tree[k] for k in _CODEC_KEYS if k in tree}
    if "istft_tables" in w:
        w["istft_tables"] = (*w["istft_tables"], hann_periodic(pcfg.n_fft))
    return pcfg, tree_to_device(_f32(w), device)


def llm_params_from_jax(cfg, tree: dict, device: torch.device,
                        dtype: torch.dtype = torch.bfloat16) -> tuple[LLMConfig, dict]:
    """JAX LLM (config, fused weight tree, the loader's default layout) ->
    the port's: the same fused leaves and a [V, D] dense logits head.
    Quantized leaf dicts ({"q", "s"}, {"q8", "s8"}, {"q4i8", "s4"}) cross
    unchanged, each array in its own dtype."""
    pcfg = LLMConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(LLMConfig)})
    w = {k: ({sk: np.array(a) for sk, a in tree[k].items()} if isinstance(tree[k], dict)
             else _f32(tree[k]))
         for k in ("token_embd", "attn_norm", "wqkv", "bqkv", "wo", "ffn_norm", "w_gateup",
                   "w_down", "q_norm", "k_norm", "output_norm", "output")}
    # a dense JAX head is [V, D] when token-major, else [D, V] (models/llm.py:385-410)
    out = w["output"]
    if (out is not None and not isinstance(out, dict)
            and not (cfg.output_token_major and out.shape[-1] == cfg.dim)):
        w["output"] = np.ascontiguousarray(out.T)
    return pcfg, weights_to_device(w, device, dtype)


def wavlm_params_from_jax(cfg, tree: dict, device: torch.device) -> tuple[WavLMConfig, dict]:
    """JAX WavLM (config, weight tree) -> the port's, at f32 on ``device``:
    the same keys and layout (linear weights [in, out], a dict a layer)."""
    return WavLMConfig(**dataclasses.asdict(cfg)), tree_to_device(_f32(tree), device)
