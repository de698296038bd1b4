"""The yardstick's arithmetic: the work a request needs, counted from the
configuration's shapes (never from the program's launches, buckets,
padding or a stream's re-decodes), the chip's peaks, and least times.

Peaks: one NVIDIA H100 SXM (data sheet, dense, 700 W): 989 TFLOP/s bf16,
67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_S = 3.35e12


def least_time(nbytes: float, flops: float, peak: float) -> float:
    """Seconds the card needs at least: bytes over the memory rate or
    operations over ``peak``, the larger."""
    return max(nbytes / HBM_BYTES_S, flops / peak)


# -- the LLM (qwen2) -----------------------------------------------------------

def llm_layer_params(c: dict) -> int:
    """Matmul weights of one layer: q, k, v, o and the SwiGLU MLP."""
    d, hd = c["dim"], c["dim"] // c["n_heads"]
    return d * c["n_heads"] * hd * 2 + 2 * d * c["n_kv_heads"] * hd + 3 * d * c["ffn"]


def vocab(c: dict) -> int:
    return 256 + 3 + c["n_audio"] + c["n_filler_vocab"]


def llm_flops(c: dict, prompt: int, n: int) -> float:
    """One pass over a request: ``prompt + n - 1`` positions through every
    layer (position p attends to p + 1 keys), the head at the ``n``
    positions whose logits pick a token."""
    P = prompt + n - 1
    keys = P * (P + 1) / 2
    return (2.0 * llm_layer_params(c) * P * c["n_layers"]
            + 4.0 * c["dim"] * keys * c["n_layers"]
            + 2.0 * c["dim"] * vocab(c) * n)


def k2_need(c: dict, prompt: int, k0: float, k1: float) -> tuple[float, float]:
    """(bytes, flops) of decode attention for generated tokens k0..k1 (a
    fraction of a token counts in part): token k attends over prompt + k + 1
    cached keys and values (bf16), reading its query and writing its output
    once."""
    hd = c["dim"] // c["n_heads"]
    L, kv, h = c["n_layers"], c["n_kv_heads"], c["n_heads"]
    n = max(0.0, k1 - k0)
    if n == 0:
        return 0.0, 0.0
    keys = n * (prompt + 1 + (k0 + k1 - 1) / 2.0)  # sum of prompt + k + 1 over the range
    nbytes = L * (2 * 2 * kv * hd * keys + 2 * 2 * h * hd * n)
    flops = L * 4.0 * h * hd * keys
    return nbytes, flops


# -- the codec ------------------------------------------------------------------

def frames(c: dict, n: int) -> int:
    return max(1, n * c["samples_per_token"] // c["hop_length"])


def _transformer_flops(rows: int, dim: int, ff: int, window: int) -> float:
    return rows * (2.0 * (4 * dim * dim + 3 * dim * ff) + 4.0 * dim * min(window, rows))


ACT_FLOPS_ROW = 2 * (12 + 12) + 2 * 12  # one anti-aliased snake, a row and channel


def k6_need(v: dict, rows: int) -> tuple[float, float]:
    """(bytes, flops) of one resblock layer over ``rows`` valid rows: two k x
    C x C convs and two activations, x in and y out with the weights once."""
    C, k = v["channels"], v["resblock_kernel"]
    flops = 2 * (2 * k * C * C) * rows + 2 * ACT_FLOPS_ROW * rows * C
    nbytes = 4 * (2 * rows * C + 2 * (k * C * C + C) + 4 * v["act_filter_len"] + 4 * C)
    return float(nbytes), float(flops)


def vocoder_rows(c: dict, v: dict, n: int) -> list[int]:
    """Valid rows at each vocoder stage of an n-code decode."""
    out, upp = [], 1
    for r in v["upsample_rates"]:
        upp *= r
        out.append(frames(c, n) * upp)
    return out


def k6_request(c: dict, v: dict, n: int) -> tuple[float, float]:
    """(bytes, flops) of every resblock layer one decode of n codes needs."""
    nb = fl = 0.0
    for rows in vocoder_rows(c, v, n):
        b, f = k6_need(v, rows)
        layers = v["num_kernels"] * 3
        nb += layers * b
        fl += layers * f
    return nb, fl


def codec_flops(cfg: dict, n: int) -> float:
    """One decode of n codes at its valid length."""
    c, v = cfg["codec"], cfg.get("vocoder")
    F = frames(c, n)
    dd = c["decoder_dim"]
    fl = c["prenet_layers"] * _transformer_flops(n, c["prenet_dim"], c["prenet_ff"],
                                                 c["prenet_window"])
    fl += 2.0 * n * c["prenet_dim"] * dd  # prenet output
    fl += 2.0 * n * dd * dd * 4  # the 2x transposed conv, k = 4
    fl += c["decoder_layers"] * _transformer_flops(F, dd, c["decoder_ff"], c["decoder_window"])
    if c["model_type"] == 0:
        fl += 2 * c["resnet_blocks"] * 2 * (2.0 * 3 * dd * dd * F)
        bins = c["n_fft"] + 2
        fl += 2.0 * F * dd * bins  # the head
        fl += 2 * 2.0 * F * (c["n_fft"] // 2 + 1) * c["n_fft"]  # the inverse DFT
        return fl
    nm, C = c["n_mels"], v["channels"]
    fl += 2.0 * F * dd * nm
    fl += v["mel_postnet_layers"] * 2.0 * F * nm * nm * v["mel_postnet_kernel"]
    fl += 2.0 * F * nm * C * 7  # conv_pre
    rows = vocoder_rows(c, v, n)
    for r, R in zip(v["upsample_rates"], rows):
        taps = 2 * int(8.0 / (0.5 / r) / 2.0) + 1
        fl += 2.0 * R * C * C * 7  # noise conv
        fl += 2 * 2.0 * R * C * taps  # the high-pass and the low-pass
        fl += 2.0 * R * C * C  # 1x1 merge
    fl += k6_request(c, v, n)[1]
    fl += ACT_FLOPS_ROW * rows[-1] * C + 2.0 * rows[-1] * C * 7  # activation_post, conv_post
    return fl


def overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    """The share of [a0, a1] inside [b0, b1] (an empty interval: 1 if its
    point lies inside)."""
    if a1 <= a0:
        return 1.0 if b0 <= a0 <= b1 else 0.0
    return max(0.0, min(a1, b1) - max(a0, b0)) / (a1 - a0)
