"""Synthetic weights from the run's seed, written as the GGUFs the server loads.

A frozen copy of the layouts of the port's synthetic writers (tensor names,
shapes, scales and the mel vocoder's taming), with the random numbers drawn
on the run's device by one ``torch.Generator`` in one call a file, scaled
there, and cast there to the type they are served in (the LLM in bf16, the
codec in f32); one copy brings each file's tensors to the host. The
configuration file (``configs/<name>.json``) gives every size.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from . import gguf
from .tokenizer import TOKEN_TYPE_CONTROL, TOKEN_TYPE_NORMAL, bytes_to_unicode

# the mel vocoder's weights at 128 channels: the scales that keep each
# stage at 0.1-0.6 std and the waveform's peak near 0.3-0.4
VOCODER_WEIGHT_SCALES = (("vocoder.conv_pre.weight", 0.1), ("vocoder.conv_post.weight", 0.3),
                         (".after.weight", 0.5), (".noise.weight", 0.5), (".convs1.", 0.3),
                         (".convs2.", 0.3))


class Plan:
    """Tensors of one GGUF: random ones (base + N(0, 1) x scale, optionally
    a row range scaled further) and fixed ones, in the order they are added."""

    def __init__(self):
        self.items: list[tuple] = []
        self.n = 0

    def rnd(self, name: str, *shape: int, scale: float | None = None, base: float = 0.0,
            rows: tuple[int, int, float] | None = None) -> None:
        if scale is None:
            scale = 1.0 / np.sqrt(max(1, shape[-1] if len(shape) >= 2 else shape[0]))
        n = int(np.prod(shape))
        self.items.append(("rnd", name, shape, self.n, float(scale), float(base), rows))
        self.n += n

    def fixed(self, name: str, arr: np.ndarray) -> None:
        self.items.append(("fixed", name, arr))

    def write(self, w: gguf.Writer, gen: torch.Generator, device: torch.device,
              bf16: bool = False) -> None:
        flat = torch.randn(self.n, generator=gen, device=device, dtype=torch.float32)
        for it in self.items:
            if it[0] != "rnd":
                continue
            _, _, shape, off, scale, base, rows = it
            part = flat[off:off + int(np.prod(shape))]
            part.mul_(scale).add_(base)
            if rows is not None:
                lo, hi, f = rows
                part.view(shape)[lo:hi].mul_(f)
        host = (flat.to(torch.bfloat16).view(torch.int16).cpu().numpy().view(np.uint16) if bf16
                else flat.cpu().numpy())
        del flat
        for it in self.items:
            if it[0] == "fixed":
                w.add_tensor(it[1], it[2])
            else:
                _, name, shape, off, *_ = it
                n = int(np.prod(shape))
                # 1-D tensors (norms, biases) stay f32, as the served GGUF has them
                arr = host[off:off + n].reshape(shape)
                if bf16 and len(shape) < 2:
                    arr = (arr.astype(np.uint32) << 16).view(np.float32)
                w.add_tensor(name, arr)
        w.write()


def synthetic_vocab(n_audio: int, n_filler: int) -> tuple[list[str], list[int]]:
    """Byte-level tokens, the chat specials, ``<|s_N|>`` audio tokens and
    fillers up to the published vocabulary."""
    tokens = list(bytes_to_unicode().values())
    types = [TOKEN_TYPE_NORMAL] * len(tokens)
    tokens += ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    types += [TOKEN_TYPE_CONTROL] * 3
    tokens += [f"<|s_{i}|>" for i in range(n_audio)]
    types += [TOKEN_TYPE_CONTROL] * n_audio
    tokens += [f"<filler_{i}>" for i in range(n_filler)]
    types += [TOKEN_TYPE_NORMAL] * n_filler
    return tokens, types


def write_llm(path: Path, c: dict, gen: torch.Generator, device: torch.device) -> None:
    """The qwen2 LLM (``configs/*.json`` "llm"), matmul weights in bf16."""
    arch, dim, nl = c["arch"], c["dim"], c["n_layers"]
    nh, nkv, ffn = c["n_heads"], c["n_kv_heads"], c["ffn"]
    hd = dim // nh
    tokens, types = synthetic_vocab(c["n_audio"], c["n_filler_vocab"])
    audio_lo = len(tokens) - c["n_audio"] - c["n_filler_vocab"]
    w = gguf.Writer(path, arch)
    w.add_string("general.type", "model")
    w.add_string("general.name", "synthetic miotts llm")
    w.add_uint32(f"{arch}.block_count", nl)
    w.add_uint32(f"{arch}.embedding_length", dim)
    w.add_uint32(f"{arch}.attention.head_count", nh)
    w.add_uint32(f"{arch}.attention.head_count_kv", nkv)
    w.add_uint32(f"{arch}.feed_forward_length", ffn)
    w.add_float32(f"{arch}.attention.layer_norm_rms_epsilon", c["rms_eps"])
    w.add_float32(f"{arch}.rope.freq_base", c["rope_base"])
    w.add_uint32(f"{arch}.context_length", c["context_length"])
    w.add_string("tokenizer.ggml.model", "gpt2")
    w.add_array_str("tokenizer.ggml.tokens", tokens)
    w.add_array_i32("tokenizer.ggml.token_type", types)
    w.add_array_str("tokenizer.ggml.merges", [])
    w.add_uint32("tokenizer.ggml.eos_token_id", tokens.index("<|im_end|>"))
    w.add_uint32("tokenizer.ggml.bos_token_id", tokens.index("<|endoftext|>"))
    w.add_bool("tokenizer.ggml.add_bos_token", False)
    p = Plan()
    p.rnd("token_embd.weight", len(tokens), dim)
    for i in range(nl):
        p.rnd(f"blk.{i}.attn_norm.weight", dim, scale=0.05 / np.sqrt(dim), base=1.0)
        p.rnd(f"blk.{i}.attn_q.weight", nh * hd, dim)
        p.rnd(f"blk.{i}.attn_q.bias", nh * hd, scale=0.05 / np.sqrt(nh * hd))
        p.rnd(f"blk.{i}.attn_k.weight", nkv * hd, dim)
        p.rnd(f"blk.{i}.attn_k.bias", nkv * hd, scale=0.05 / np.sqrt(nkv * hd))
        p.rnd(f"blk.{i}.attn_v.weight", nkv * hd, dim)
        p.rnd(f"blk.{i}.attn_v.bias", nkv * hd, scale=0.05 / np.sqrt(nkv * hd))
        p.rnd(f"blk.{i}.attn_output.weight", dim, nh * hd)
        p.rnd(f"blk.{i}.ffn_norm.weight", dim, scale=0.05 / np.sqrt(dim), base=1.0)
        p.rnd(f"blk.{i}.ffn_gate.weight", ffn, dim)
        p.rnd(f"blk.{i}.ffn_up.weight", ffn, dim)
        p.rnd(f"blk.{i}.ffn_down.weight", dim, ffn)
    p.rnd("output_norm.weight", dim, scale=0.05 / np.sqrt(dim), base=1.0)
    p.rnd("output.weight", len(tokens), dim,
          rows=(audio_lo, audio_lo + c["n_audio"], c["audio_logit_scale"]))
    p.write(w, gen, device, bf16=True)


def _codec_kv(w: gguf.Writer, c: dict) -> None:
    for key in ("model_type", "sample_rate", "n_fft", "hop_length", "n_mels", "samples_per_token",
                "prenet_layers", "prenet_dim", "prenet_heads", "prenet_ff", "prenet_window",
                "decoder_layers", "decoder_dim", "decoder_heads", "decoder_ff", "decoder_window",
                "decoder_adanorm_dim", "resnet_blocks", "resnet_groups"):
        w.add_uint32(f"miocodec.{key}", c[key])
    w.add_uint32("miocodec.dynamic_global", 1)
    w.add_uint32("miocodec.wave_upsampler_layers", 0)
    for key in ("rope_theta", "norm_eps", "group_norm_eps"):
        w.add_float32(f"miocodec.{key}", c[key])


def _transformer(p: Plan, prefix: str, n: int, dim: int, ff: int, cond_dim: int | None) -> None:
    for i in range(n):
        b = f"{prefix}.blk.{i}"
        if cond_dim is None:
            for nm in ("attn_norm", "ffn_norm"):
                p.rnd(f"{b}.{nm}.weight", dim, scale=0.05, base=1.0)
                p.rnd(f"{b}.{nm}.bias", dim, scale=0.05)
        else:
            for nm in ("attn_cond", "ffn_cond"):
                p.rnd(f"{b}.{nm}.weight", 3 * dim, cond_dim, scale=0.1)
                p.rnd(f"{b}.{nm}.bias", 3 * dim, scale=0.1)
        for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
            p.rnd(f"{b}.{nm}.weight", dim, dim)
        p.rnd(f"{b}.ffn_gate.weight", ff, dim)
        p.rnd(f"{b}.ffn_down.weight", dim, ff)
        p.rnd(f"{b}.ffn_up.weight", ff, dim)


def _trunk(p: Plan, c: dict) -> None:
    pd, dd = c["prenet_dim"], c["decoder_dim"]
    p.rnd("token_embd", c["vocab_size"], pd, scale=0.5)
    _transformer(p, "wave_prenet", c["prenet_layers"], pd, c["prenet_ff"], None)
    p.rnd("wave_prenet.norm.weight", pd, scale=0.05, base=1.0)
    p.rnd("wave_prenet.norm.bias", pd, scale=0.05)
    p.rnd("wave_prenet.output.weight", dd, pd)
    p.rnd("wave_prenet.output.bias", dd, scale=0.05)
    p.rnd("wave_upsample.weight", dd, dd, 4)  # ConvTranspose1d [in, out, k]
    p.rnd("wave_upsample.bias", dd, scale=0.05)


def _resnets(p: Plan, prefix: str, n: int, ch: int) -> None:
    for i in range(n):
        for j in (1, 2):
            p.rnd(f"{prefix}.{i}.norm{j}.weight", ch, scale=0.05, base=1.0)
            p.rnd(f"{prefix}.{i}.norm{j}.bias", ch, scale=0.05)
            p.rnd(f"{prefix}.{i}.conv{j}.weight", ch, ch, 3)
            p.rnd(f"{prefix}.{i}.conv{j}.bias", ch, scale=0.05)


def _decoder(p: Plan, c: dict) -> None:
    dd, ad = c["decoder_dim"], c["decoder_adanorm_dim"]
    _transformer(p, "wave_decoder", c["decoder_layers"], dd, c["decoder_ff"], ad)
    p.rnd("wave_decoder.norm_cond.weight", 2 * dd, ad, scale=0.1)
    p.rnd("wave_decoder.norm_cond.bias", 2 * dd, scale=0.1)


def write_wave_codec(path: Path, c: dict, gen: torch.Generator, device: torch.device) -> None:
    """The 24 kHz wave MioCodec with its iSTFT head (no global encoder: no
    cell clones a voice)."""
    w = gguf.Writer(path, "miocodec-dec")
    w.add_string("general.type", "model")
    _codec_kv(w, c)
    w.add_uint32("miocodec.has_vocoder", 0)
    p = Plan()
    _trunk(p, c)
    _resnets(p, "wave_prior", c["resnet_blocks"], c["decoder_dim"])
    _resnets(p, "wave_post", c["resnet_blocks"], c["decoder_dim"])
    _decoder(p, c)
    p.rnd("istft_head.out.weight", c["n_fft"] + 2, c["decoder_dim"], scale=0.02)
    p.rnd("istft_head.out.bias", c["n_fft"] + 2, scale=0.02)
    p.write(w, gen, device)


def _tame(name: str) -> float:
    f = 1.0
    if name.endswith(".weight"):
        for key, s in VOCODER_WEIGHT_SCALES:
            if key in name:
                f *= s
    return f


def write_mel_codec(path: Path, c: dict, v: dict, gen: torch.Generator,
                    device: torch.device) -> None:
    """The mel MioCodec: the trunk, the mel head and postnet, and the
    BigVGAN-style vocoder (``configs/*.json`` "vocoder"), tamed."""
    w = gguf.Writer(path, "miocodec-dec")
    w.add_string("general.type", "model")
    _codec_kv(w, c)
    w.add_uint32("miocodec.has_vocoder", 1)
    w.add_uint32("miocodec.mel_postnet_layers", v["mel_postnet_layers"])
    w.add_uint32("miocodec.mel_postnet_kernel_size", v["mel_postnet_kernel"])
    rates, nk, ch, nm = v["upsample_rates"], v["num_kernels"], v["channels"], c["n_mels"]
    w.add_uint32("miovocoder.sample_rate", c["sample_rate"])
    w.add_uint32("miovocoder.n_mels", nm)
    w.add_uint32("miovocoder.num_upsamples", len(rates))
    w.add_uint32("miovocoder.num_kernels", nk)
    p = Plan()
    _trunk(p, c)
    _decoder(p, c)
    p.rnd("istft_head.out.weight", nm, c["decoder_dim"], scale=0.1)
    p.rnd("istft_head.out.bias", nm, scale=0.05)
    k = v["mel_postnet_kernel"]
    for i in range(v["mel_postnet_layers"]):
        p.rnd(f"mel_postnet.{i}.conv.weight", nm, nm, k, scale=0.1)
        p.rnd(f"mel_postnet.{i}.conv.bias", nm, scale=0.05)
        p.rnd(f"mel_postnet.{i}.norm.weight", nm, scale=0.05, base=1.0)
        p.rnd(f"mel_postnet.{i}.norm.bias", nm, scale=0.05)
    p.fixed("miovocoder.upsample_rates", np.asarray(rates, np.int32))

    def rnd(name, *shape, scale):
        p.rnd(name, *shape, scale=scale * _tame(name))

    rnd("vocoder.conv_pre.weight", ch, nm, 7, scale=0.1)
    rnd("vocoder.conv_pre.bias", ch, scale=0.02)
    rnd("vocoder.conv_post.weight", 1, ch, 7, scale=0.1)
    for i in range(len(rates)):
        rnd(f"vocoder.ups.{i}.after.weight", ch, ch, 1, scale=0.2)
        rnd(f"vocoder.ups.{i}.after.bias", ch, scale=0.02)
        rnd(f"vocoder.ups.{i}.noise.weight", ch, ch, 7, scale=0.1)
        rnd(f"vocoder.ups.{i}.noise.bias", ch, scale=0.02)
    n = v["act_filter_len"]
    filt = np.hanning(n + 2)[1:-1].astype(np.float32)
    filt = (filt / filt.sum()).reshape(-1, 1, 1)
    rk = v["resblock_kernel"]

    def act(prefix):
        rnd(f"{prefix}.alpha", ch, scale=0.1)
        rnd(f"{prefix}.beta", ch, scale=0.1)
        p.fixed(f"{prefix}.up_filter", filt)
        p.fixed(f"{prefix}.down_filter", filt)

    for r in range(len(rates) * nk):
        for j in range(3):
            for conv in ("convs1", "convs2"):
                rnd(f"vocoder.resblocks.{r}.{conv}.{j}.weight", ch, ch, rk, scale=0.1)
                rnd(f"vocoder.resblocks.{r}.{conv}.{j}.bias", ch, scale=0.02)
        for a in range(6):
            act(f"vocoder.resblocks.{r}.acts.{a}")
    act("vocoder.activation_post")
    p.write(w, gen, device)


def write_embedding(path: Path, dim: int, gen: torch.Generator, device: torch.device) -> None:
    """A speaker embedding, N(0, 1), as the server's ``--reference-file`` reads it."""
    emb = torch.randn(dim, generator=gen, device=device).cpu().numpy()
    w = gguf.Writer(path, "mio-embedding")
    w.add_string("general.type", "embedding")
    w.add_uint32("mio.embedding.dim", dim)
    w.add_tensor("mio.global_embedding", emb)
    w.write()


def write_all(out: Path, cfg: dict, seed: int, device: torch.device) -> dict[str, Path]:
    """Every GGUF the configuration's server loads, from ``seed``; returns
    their paths by role ("llm", "codec", "voice")."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    out.mkdir(parents=True, exist_ok=True)
    paths = {"llm": out / "llm.gguf", "codec": out / "codec.gguf", "voice": out / "voice.emb.gguf"}
    write_llm(paths["llm"], cfg["llm"], gen, device)
    if cfg.get("vocoder"):
        write_mel_codec(paths["codec"], cfg["codec"], cfg["vocoder"], gen, device)
    else:
        write_wave_codec(paths["codec"], cfg["codec"], gen, device)
    write_embedding(paths["voice"], cfg["codec"]["decoder_adanorm_dim"], gen, device)
    return paths
