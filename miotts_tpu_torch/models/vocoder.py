"""BigVGAN-style MioVocoder: mel -> waveform, for mel-mode codecs
(miotts_tpu/models/vocoder.py).

Mirrors decode_mel_to_audio (miocodec-decoder.cpp:1666-2119) as one
batched, length-masked forward over [B, T, C]:

- mel postnet: conv(pad=(k-1)/2) -> per-time channel LN -> tanh (residual)
- per upsample stage: zero-stuff + julius low-pass for the signal branch,
  zero-stuff + "noise" conv + high-pass for the source branch, 1x1 merge,
  then AMP resblocks (anti-aliased ADAA snake-beta between dilated convs)
- anti-aliased activation after the last stage, conv_post, clip to [-1, 1]

The three dispatchers below keep the JAX package's shape conditions, so the
launch structure is the same: ``conv1d_same`` takes kernel K4 for an odd k,
``activation1d`` kernel K5 (1-D filters, up filter of at least 2 taps), and
``_resblock_layer`` kernel K6 when the layer's convs are square C x C with
odd k and biases and the (padded) length is at least 1024 rows; else the
layer runs as K5, K4, K5, K4. K5 and K6 run one activation
(``csrc/vocoder_common.cuh`` act_channel, with the reference kernel's
default fast sin/cos), so both routes round alike on the card. The device
alone decides whether a kernel runs: a CUDA tensor reaches the kernel (or
an error), a CPU tensor its plain version. Other convolutions (conv_pre/post, the postnet, the
depthwise FIRs) are ``F.conv1d``, as the JAX package leaves them to XLA.
The vocoder's own matmul and convolutions (conv_pre, the postnet, the 1x1
merge, conv_post) run at the codec's ``MIOTTS_CODEC_MATMUL`` precision
(``ops/precision.py``); the kernels, the FIRs and the activations keep f32.

Not ported: the opt-in grouped path that folds a stage's resblocks into
the channel axis (JAX's ``_resblocks_fused``, ``MIOTTS_VOCODER_FUSE=1``,
off by default there), which the port does not read: it always runs the
K6 path, whose audio the folded one equals, and the folded stage in plain
PyTorch took 11.7x the K6 path's time on an H100. Nor the XLA-pinned
dispatch of the sequence-parallel path.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.cuda import activation1d as k5
from ..ops.cuda import conv1d as k4
from ..ops.cuda import resblock as k6
from ..ops.masking import mask_time
from ..ops.precision import mm, operand
from ..ops.resample import (
    conv1d_zeropad, highpass, lowpass, per_time_layer_norm, zero_stuff)

RESBLOCK_DILATIONS = (1, 3, 5)
_FUSE_MIN_ROWS = 1024  # the JAX package's threshold for the fused layer


def conv1d_same(x, lengths, w, b, dilation: int = 1, residual=None) -> torch.Tensor:
    """mask_time(conv1d_zeropad(x, w, b, d, d*(k-1)/2)) [+ residual]."""
    k = int(w.shape[-1])
    if k % 2 == 1:
        return k4.conv1d_same(x, lengths, w, b, dilation, residual)
    y = mask_time(conv1d_zeropad(x, w, b, dilation, (k * dilation - dilation) // 2), lengths)
    return y if residual is None else y + residual


def activation1d(x, lengths, act: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Anti-aliased snake: 2x upsample -> ADAA snake-beta -> 2x downsample;
    returns (y, lengths). On the card this is K5, whose snake is K6's (the
    fast sin/cos the JAX package's kernel uses by default). The JAX
    package's composite route serves only filter banks and a 1-tap up
    filter; the port's loader yields neither, and K5 refuses a 1-tap filter
    on the card."""
    return k5.activation1d(x, lengths, act["up_filter"], act["alpha"], act["beta"],
                           act["down_filter"]), lengths


def _resblock_layer(r, r_len, rb: dict, kk: int, dil: int) -> torch.Tensor:
    """One resblock layer: conv2(actB(conv1(actA(r)))) + r, same length."""
    actA, actB = rb["acts"][2 * kk], rb["acts"][2 * kk + 1]
    w1, b1 = rb["convs1"][kk]["w"], rb["convs1"][kk]["b"]
    w2, b2 = rb["convs2"][kk]["w"], rb["convs2"][kk]["b"]
    C = r.shape[-1]
    fusable = (actA["up_filter"].shape[0] >= 2 and actB["up_filter"].shape[0] >= 2
               and w1.shape[-1] % 2 == 1 and w2.shape[-1] % 2 == 1
               and b1 is not None and b2 is not None
               and w1.shape[0] == w1.shape[1] == C and w2.shape[0] == w2.shape[1] == C
               and r.shape[1] >= _FUSE_MIN_ROWS)
    if fusable:
        return k6.resblock_layer(r, r_len, actA, w1, b1, dil, actB, w2, b2)
    r1, l1 = activation1d(r, r_len, actA)
    r1 = conv1d_same(r1, l1, w1, b1, dil)
    r2, l2 = activation1d(r1, l1, actB)
    # activation1d preserves the length; conv2 + residual + mask in one call
    return conv1d_same(r2, l2, w2, b2, 1, residual=r)


def mel_postnet_apply(cfg, w: dict, mel: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Residual mel postnet (miocodec-decoder.cpp:2001-2020). mel: [B, T, n_mels]."""
    if "mel_postnet" not in w:
        return mel
    blocks = w["mel_postnet"]
    n = blocks["conv_w"].shape[0]
    r = mel
    for i in range(n):
        blk = {k: v[i] for k, v in blocks.items()}
        k = blk["conv_w"].shape[-1]
        r = mask_time(r, lengths)
        r = conv1d_zeropad(operand(r), operand(blk["conv_w"]), blk["conv_b"], 1,
                           max(0, (k - 1) // 2))
        r = per_time_layer_norm(r, blk["norm_w"], blk["norm_b"], cfg.norm_eps)
        if i + 1 < n:
            r = torch.tanh(r)
    return mel + mask_time(r, lengths)


def vocoder_decode(cfg, w: dict, mel: torch.Tensor, lengths: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """mel [B, T, n_mels] -> (audio [B, S], n_samples [B]), S = T * prod(rates)."""
    v = w["vocoder"]
    num_k = cfg.vocoder_num_kernels
    mel = mel_postnet_apply(cfg, w, mask_time(mel, lengths), lengths)

    x = mask_time(conv1d_zeropad(operand(mel), operand(v["conv_pre_w"]), v["conv_pre_b"], 1, 3),
                  lengths)
    x0, x0_len, cur_len = x, lengths, lengths
    upp = 1
    for i, scale in enumerate(cfg.vocoder_upsample_rates):
        upp *= scale
        up = v["ups"][i]
        # source branch: the stage input's pre-net features at the new rate
        y0 = zero_stuff(mask_time(x0, x0_len), upp)
        y0_len = x0_len * upp
        y0 = conv1d_same(y0, y0_len, up["noise_w"], up["noise_b"], 1)
        y0 = highpass(y0, y0_len, 0.5 / scale)
        # signal branch
        y = zero_stuff(mask_time(x, cur_len), scale)
        y, cur_len = lowpass(y, cur_len * scale, 0.5 / scale, 1)
        x = mask_time(mm(y + y0, up["after_w"][:, :, 0].T) + up["after_b"], cur_len)  # 1x1 conv

        xs = torch.zeros_like(x)
        for rb in v["resblocks"][i * num_k:(i + 1) * num_k]:
            r = x
            for kk, dil in enumerate(RESBLOCK_DILATIONS):
                r = _resblock_layer(r, cur_len, rb, kk, dil)
            xs = xs + r
        x = xs * (1.0 / max(1, num_k))

    x, cur_len = activation1d(x, cur_len, v["activation_post"])
    x = mask_time(conv1d_zeropad(operand(x), operand(v["conv_post_w"]), None, 1, 3), cur_len)
    return torch.clamp(x[:, :, 0], -1.0, 1.0), cur_len


def load_vocoder_weights(reader_get, cfg) -> dict[str, Any]:
    """Read vocoder tensors (names: convert_miocodec_to_gguf.py:618-670)."""
    v: dict[str, Any] = {
        "conv_pre_w": reader_get("vocoder.conv_pre.weight"),
        "conv_pre_b": reader_get("vocoder.conv_pre.bias"),
        "conv_post_w": reader_get("vocoder.conv_post.weight"),
    }
    v["ups"] = [{
        "after_w": reader_get(f"vocoder.ups.{i}.after.weight"),
        "after_b": reader_get(f"vocoder.ups.{i}.after.bias"),
        "noise_w": reader_get(f"vocoder.ups.{i}.noise.weight"),
        "noise_b": reader_get(f"vocoder.ups.{i}.noise.bias"),
    } for i in range(len(cfg.vocoder_upsample_rates))]

    def act(p):
        return {"alpha": reader_get(f"{p}.alpha"), "beta": reader_get(f"{p}.beta"),
                "up_filter": reader_get(f"{p}.up_filter").reshape(-1),
                "down_filter": reader_get(f"{p}.down_filter").reshape(-1)}

    n_rb = len(cfg.vocoder_upsample_rates) * cfg.vocoder_num_kernels
    v["resblocks"] = [{
        "convs1": [{"w": reader_get(f"vocoder.resblocks.{r}.convs1.{c}.weight"),
                    "b": reader_get(f"vocoder.resblocks.{r}.convs1.{c}.bias")} for c in range(3)],
        "convs2": [{"w": reader_get(f"vocoder.resblocks.{r}.convs2.{c}.weight"),
                    "b": reader_get(f"vocoder.resblocks.{r}.convs2.{c}.bias")} for c in range(3)],
        "acts": [act(f"vocoder.resblocks.{r}.acts.{a}") for a in range(6)],
    } for r in range(n_rb)]
    v["activation_post"] = act("vocoder.activation_post")
    return v
