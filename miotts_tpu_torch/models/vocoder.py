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

Sequence parallelism (``vocoder_decode_sp``): each rank runs the same
dispatchers, so K4, K5 and K6 stay on the path, on its rows of each
upsample stage grown by one halo that covers the stage's reach, where the
JAX package pins its sp vocoder to XLA (a pallas_call is opaque to GSPMD).

Not ported: the opt-in grouped path that folds a stage's resblocks into
the channel axis (JAX's ``_resblocks_fused``, ``MIOTTS_VOCODER_FUSE=1``,
off by default there), which the port does not read: it always runs the
K6 path, whose audio the folded one equals, and the folded stage in plain
PyTorch took 11.7x the K6 path's time on an H100.
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
    conv1d_zeropad, highpass, julius_lowpass_kernel, lowpass, per_time_layer_norm, zero_stuff)
from ..parallel import sequence as seq

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


def _pre(cfg, w: dict, mel: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The mel postnet and conv_pre (k=7)."""
    v = w["vocoder"]
    mel = mel_postnet_apply(cfg, w, mask_time(mel, lengths), lengths)
    return mask_time(conv1d_zeropad(operand(mel), operand(v["conv_pre_w"]), v["conv_pre_b"], 1, 3),
                     lengths)


def _stage(v: dict, i: int, scale: int, num_k: int, y0: torch.Tensor, y: torch.Tensor,
           lengths: torch.Tensor) -> torch.Tensor:
    """Upsample stage i after its zero-stuffing: the source branch ``y0``
    (the pre-net features at the new rate) through the noise conv and the
    high-pass, the signal ``y`` through the low-pass, the 1x1 merge, then the
    mean of the stage's resblocks; ``lengths`` at the new rate."""
    up = v["ups"][i]
    y0 = conv1d_same(y0, lengths, up["noise_w"], up["noise_b"], 1)
    y0 = highpass(y0, lengths, 0.5 / scale)
    y, _ = lowpass(y, lengths, 0.5 / scale, 1)
    x = mask_time(mm(y + y0, up["after_w"][:, :, 0].T) + up["after_b"], lengths)  # 1x1 conv
    xs = torch.zeros_like(x)
    for rb in v["resblocks"][i * num_k:(i + 1) * num_k]:
        r = x
        for kk, dil in enumerate(RESBLOCK_DILATIONS):
            r = _resblock_layer(r, lengths, rb, kk, dil)
        xs = xs + r
    return xs * (1.0 / max(1, num_k))


def _post(v: dict, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """activation_post, conv_post (k=7, no bias) and the clamp to [-1, 1]."""
    x, _ = activation1d(x, lengths, v["activation_post"])
    x = mask_time(conv1d_zeropad(operand(x), operand(v["conv_post_w"]), None, 1, 3), lengths)
    return torch.clamp(x[:, :, 0], -1.0, 1.0)


def vocoder_decode(cfg, w: dict, mel: torch.Tensor, lengths: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """mel [B, T, n_mels] -> (audio [B, S], n_samples [B]), S = T * prod(rates)."""
    v = w["vocoder"]
    x0 = x = _pre(cfg, w, mel, lengths)
    upp = 1
    for i, scale in enumerate(cfg.vocoder_upsample_rates):
        upp *= scale
        x = _stage(v, i, scale, cfg.vocoder_num_kernels, zero_stuff(mask_time(x0, lengths), upp),
                   zero_stuff(mask_time(x, lengths * (upp // scale)), scale), lengths * upp)
    return _post(v, x, lengths * upp), lengths * upp


# ---------------------------------------------------------------------------
# Sequence parallelism: the vocoder on an ("sp",) mesh's split rows
# ---------------------------------------------------------------------------

def _act_reach(act: dict) -> int:
    """Rows an Activation1d output reads before or after its own
    (``ops/cuda/activation1d.py act_geom``, the snake's previous sample
    included), plus one."""
    g = k5.act_geom(act["up_filter"].shape[0], act["down_filter"].shape[0])
    return max(g.hlo, g.hhi) + 1


def resblock_reach(rb: dict) -> int:
    """The reach of one AMP resblock's three layers in a row: per layer two
    activations, conv1's d (k1 - 1)/2 and conv2's (k2 - 1)/2 rows."""
    total = 0
    for kk, dil in enumerate(RESBLOCK_DILATIONS):
        k1, k2 = rb["convs1"][kk]["w"].shape[-1], rb["convs2"][kk]["w"].shape[-1]
        total += (_act_reach(rb["acts"][2 * kk]) + dil * (k1 - 1) // 2
                  + _act_reach(rb["acts"][2 * kk + 1]) + (k2 - 1) // 2)
    return total


def stage_reach(v: dict, i: int, num_k: int, scale: int) -> int:
    """The reach of upsample stage i at its output rate: the noise conv and
    the high-pass of the source branch (the signal's low-pass, of the same
    cutoff, reaches no further), then the deepest of its resblocks."""
    half = julius_lowpass_kernel(round(0.5 / scale, 9)).shape[0] // 2
    noise = (v["ups"][i]["noise_w"].shape[-1] - 1) // 2
    rbs = v["resblocks"][i * num_k:(i + 1) * num_k]
    return noise + half + max((resblock_reach(rb) for rb in rbs), default=0)


def vocoder_decode_sp(cfg, ws: list, mel: "seq.Sharded", lengths: list
                      ) -> tuple["seq.Sharded", torch.Tensor]:
    """``vocoder_decode`` over split rows: (audio split over its samples,
    n_samples [B] on the lead). ``ws`` holds each rank's weights and
    ``lengths`` each rank's copy of the mel frame lengths. Three halos:

    - the postnet and conv_pre on one, of their kernels' widths;
    - each upsample stage on one at its output rate, ``stage_reach`` rows
      (and a few more) a side: a rank fetches the stage input (and the
      conv_pre features of the source branch) that its extended rows need,
      zero-stuffs, filters, merges and runs the stage's resblocks (K6, or
      K5 + K4 where the extended part has under 1 024 rows; K4 for the
      noise conv) with the lengths its part sees, then keeps its own rows;
    - activation_post (K5) and conv_post on the last, the act's reach plus
      the conv's width.

    Halos are trimmed at the global edges, so the replicate pads and the
    snake's first sample read the sequence's own edge on the edge ranks;
    at an inner edge the rows a filter reads wrong lie within the reach and
    are dropped. The length's own edge, where it falls inside a part
    (halo or not), is the true edge there."""
    mesh = mel.mesh
    num_k = cfg.vocoder_num_kernels
    v0 = ws[0]["vocoder"]
    reach = v0["conv_pre_w"].shape[-1]
    if "mel_postnet" in ws[0]:
        pn = ws[0]["mel_postnet"]["conv_w"]
        reach += pn.shape[0] * pn.shape[-1]
    x0 = x = seq.on_halo(mel, reach, reach, lambda r, p, start: _pre(
        cfg, ws[r], p, seq.local_lengths(lengths[r], start, p.shape[1])))

    upp = 1
    for i, scale in enumerate(cfg.vocoder_upsample_rates):
        upp *= scale
        T = x.total * scale
        out_rows = seq.split_rows(T, mesh.devices.size)
        ext = seq.halo_ranges(out_rows, T, *(2 * [stage_reach(v0, i, num_k, scale) + 8]),
                              edge="trim")
        src = seq.fetch(x, [(a // scale, -(-b // scale)) for a, b in ext])
        src0 = seq.fetch(x0, [(a // upp, -(-b // upp)) for a, b in ext])

        def stage(r, i=i, scale=scale, upp=upp, src=src, src0=src0, ext=ext):
            e0, e1 = ext[r]

            def stuffed(s, factor, lens):
                """A fetched part zero-stuffed by ``factor``, cut to the rows [e0, e1)."""
                part, start = s.parts[r], s.starts[r]
                y = zero_stuff(mask_time(part, seq.local_lengths(lens, start, part.shape[1])),
                               factor)
                return y[:, e0 - factor * start:e1 - factor * start].contiguous()
            return _stage(ws[r]["vocoder"], i, scale, num_k, stuffed(src0, upp, lengths[r]),
                          stuffed(src, scale, lengths[r] * (upp // scale)),
                          seq.local_lengths(lengths[r] * upp, e0, e1 - e0))
        parts = seq.per_rank(mesh, stage)
        x = seq.crop(seq.Sharded(parts, [a for a, _ in ext], T, mesh), out_rows)

    reach = _act_reach(v0["activation_post"]) + v0["conv_post_w"].shape[-1]
    return seq.on_halo(x, reach, reach, lambda r, p, start: _post(
        ws[r]["vocoder"], p, seq.local_lengths(lengths[r] * upp, start, p.shape[1]))), \
        lengths[0] * upp


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
