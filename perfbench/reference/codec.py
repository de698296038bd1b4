"""The plain MioCodec decoder (codes -> waveform), in float32, from the GGUF
as written: the reference the served audio is judged by.

One request a call, at its exact length, so no padding and no masks; plain
PyTorch ops only (dense banded attention, ``F.conv1d``), after the
description that the reference C++ decoder gives (miocodec-decoder.cpp):
the prenet transformer, the 2x transposed conv, the bilinear resize, the
resnets, the AdaLN-conditioned decoder transformer, then either the iSTFT
head (wave mode) or the mel head, its postnet and the BigVGAN-style
vocoder with anti-aliased snake activations (mel mode). Matmuls and convs
run at the precision the caller leaves set (``torch.backends`` TF32
switches): off for the reference, on for its control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf import Reader

RESBLOCK_DILATIONS = (1, 3, 5)


class Codec:
    def __init__(self, path: str, device: torch.device):
        with Reader(path) as r:
            kv = r.kv

            def u(key, default=0):
                return int(kv.get(f"miocodec.{key}", default))

            self.model_type = u("model_type")
            self.spt, self.hop, self.n_fft = u("samples_per_token"), u("hop_length"), u("n_fft")
            self.sample_rate = u("sample_rate")
            self.prenet = (u("prenet_layers"), u("prenet_heads"), u("prenet_window"))
            self.decoder = (u("decoder_layers"), u("decoder_heads"), u("decoder_window"))
            self.resnet_blocks, self.groups = u("resnet_blocks"), u("resnet_groups", 32)
            self.theta = float(kv.get("miocodec.rope_theta", 10000.0))
            self.eps = float(kv.get("miocodec.norm_eps", 1e-5))
            self.gn_eps = float(kv.get("miocodec.group_norm_eps", 1e-6))
            self.has_vocoder = bool(u("has_vocoder"))
            self.postnet_layers = u("mel_postnet_layers")
            self.rates = (tuple(int(x) for x in r.tensor("miovocoder.upsample_rates"))
                          if self.has_vocoder else ())
            self.num_k = int(kv.get("miovocoder.num_kernels", 0))
            self.w = {n: torch.from_numpy(r.tensor(n)).to(device) for n in r.infos
                      if not n.startswith("miovocoder.")}
        self.device = device

    # -- trunk ---------------------------------------------------------------

    def decoder_frames(self, n: int) -> int:
        return max(1, (n * self.spt) // self.hop)

    def _ln(self, x, w=None, b=None):
        x = F.layer_norm(x, x.shape[-1:], eps=self.eps)
        return x if w is None else x * w + b

    def _rope(self, x):
        """NORM-mode RoPE of x [T, H, D]: adjacent pairs rotate."""
        T, H, D = x.shape
        inv = torch.pow(self.theta, torch.arange(D // 2, device=x.device, dtype=torch.float32)
                        * (-2.0 / D))
        ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] * inv
        c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        a, b = x[..., 0::2], x[..., 1::2]
        return torch.stack([a * c - b * s, a * s + b * c], dim=-1).reshape(T, H, D)

    def _transformer(self, x, prefix: str, n: int, heads: int, window: int, cond):
        T, C = x.shape
        hd = C // heads
        i = torch.arange(T, device=x.device)
        band = (i[:, None] - i[None, :]).abs() <= window // 2
        w = self.w
        for li in range(n):
            p = f"{prefix}.blk.{li}"
            if cond is not None:
                a = cond @ w[f"{p}.attn_cond.weight"].t() + w[f"{p}.attn_cond.bias"]
                shift, scale, gate = a[:C], a[C:2 * C], a[2 * C:]
                xn = self._ln(x) * (1.0 + scale) + shift
            else:
                gate = None
                xn = self._ln(x, w[f"{p}.attn_norm.weight"], w[f"{p}.attn_norm.bias"])
            q = self._rope((xn @ w[f"{p}.attn_q.weight"].t()).view(T, heads, hd))
            k = self._rope((xn @ w[f"{p}.attn_k.weight"].t()).view(T, heads, hd))
            v = (xn @ w[f"{p}.attn_v.weight"].t()).view(T, heads, hd)
            s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
            att = torch.einsum("hqk,khd->qhd", torch.softmax(s.masked_fill(~band, float("-inf")),
                                                             dim=-1), v)
            out = att.reshape(T, C) @ w[f"{p}.attn_output.weight"].t()
            h = x + (out * gate if gate is not None else out)
            if cond is not None:
                a = cond @ w[f"{p}.ffn_cond.weight"].t() + w[f"{p}.ffn_cond.bias"]
                shift, scale, fgate = a[:C], a[C:2 * C], a[2 * C:]
                fn = self._ln(h) * (1.0 + scale) + shift
            else:
                fgate = None
                fn = self._ln(h, w[f"{p}.ffn_norm.weight"], w[f"{p}.ffn_norm.bias"])
            ff = (F.silu(fn @ w[f"{p}.ffn_gate.weight"].t()) * (fn @ w[f"{p}.ffn_up.weight"].t())
                  ) @ w[f"{p}.ffn_down.weight"].t()
            x = h + (ff * fgate if fgate is not None else ff)
        return x

    def _conv(self, x, wt, b=None, dilation: int = 1, groups: int = 1):
        """Zero-padded 'same' conv of x [T, C] with a torch-layout weight."""
        k = wt.shape[-1]
        y = F.conv1d(x.t()[None], wt, None, padding=dilation * (k - 1) // 2, dilation=dilation,
                     groups=groups)[0].t()
        return y if b is None else y + b

    def _resnet(self, x, p: str):
        C = x.shape[-1]
        g = max(1, min(self.groups, C))
        while g > 1 and C % g:
            g -= 1
        w = self.w
        y = x
        for j in (1, 2):
            y = F.group_norm(y.t()[None], g, eps=self.gn_eps)[0].t()
            y = F.silu(y * w[f"{p}.norm{j}.weight"] + w[f"{p}.norm{j}.bias"])
            y = self._conv(y, w[f"{p}.conv{j}.weight"], w[f"{p}.conv{j}.bias"])
        return x + y

    def _interp(self, y, dst: int, anchor: int | None):
        """Bilinear resize along time, half-pixel centres, indices clamped."""
        src = y.shape[0]
        if anchor is not None:
            sf = self.decoder_frames(anchor) / ((anchor - 1) * 2 + self.w["wave_upsample.weight"]
                                                .shape[-1])
        else:
            sf = dst / max(src, 1)
        sf = torch.tensor(sf, dtype=torch.float32, device=y.device)
        pos = (torch.arange(dst, dtype=torch.float32, device=y.device) + 0.5) / sf - 0.5
        x0f = torch.floor(pos)
        dx = (pos - x0f)[:, None]
        x0 = x0f.long().clamp(0, src - 1)
        x1 = (x0f.long() + 1).clamp(0, src - 1)
        return y[x0] + (y[x1] - y[x0]) * dx

    def spec(self, codes: list[int], emb: np.ndarray, anchor: int | None) -> torch.Tensor:
        """Codes -> the head's input projected: spec [frames, bins]."""
        w = self.w
        n = len(codes)
        cond = F.silu(torch.from_numpy(np.asarray(emb, np.float32)).to(self.device))
        x = w["token_embd"][torch.tensor(codes, device=self.device)]
        x = self._transformer(x, "wave_prenet", *self.prenet, None)
        x = self._ln(x, w["wave_prenet.norm.weight"], w["wave_prenet.norm.bias"])
        x = x @ w["wave_prenet.output.weight"].t() + w["wave_prenet.output.bias"]
        y = F.conv_transpose1d(x.t()[None], w["wave_upsample.weight"], stride=2)[0].t()
        y = self._interp(y + w["wave_upsample.bias"], self.decoder_frames(n), anchor)
        if self.model_type == 0:
            for i in range(self.resnet_blocks):
                y = self._resnet(y, f"wave_prior.{i}")
        x = self._transformer(y, "wave_decoder", *self.decoder, cond)
        dim = x.shape[-1]
        a = cond @ w["wave_decoder.norm_cond.weight"].t() + w["wave_decoder.norm_cond.bias"]
        x = self._ln(x) * (1.0 + a[dim:]) + a[:dim]
        if self.model_type == 0:
            for i in range(self.resnet_blocks):
                x = self._resnet(x, f"wave_post.{i}")
        return x @ w["istft_head.out.weight"].t() + w["istft_head.out.bias"]

    # -- heads -----------------------------------------------------------------

    def _istft(self, spec):
        n_fft, hop = self.n_fft, self.hop
        n_freq = n_fft // 2 + 1
        L = spec.shape[0]
        mag = torch.clamp(torch.exp(spec[:, :n_freq]), max=1e2)
        ph = spec[:, n_freq:]
        k = torch.arange(n_freq, dtype=torch.float64, device=spec.device)[:, None]
        t = torch.arange(n_fft, dtype=torch.float64, device=spec.device)[None, :]
        ang = 2.0 * math.pi * k * t / n_fft
        cos_t = (torch.cos(ang) / n_freq).float()
        sin_t = (torch.sin(ang) / n_freq).float()
        frames = (mag * torch.cos(ph)) @ cos_t - (mag * torch.sin(ph)) @ sin_t  # [L, n_fft]
        i = torch.arange(n_fft, dtype=torch.float64, device=spec.device)
        hann = (0.5 * (1.0 - torch.cos(2.0 * math.pi * i / n_fft))).float()
        total = (L - 1) * hop + n_fft
        fold = dict(output_size=(1, total), kernel_size=(1, n_fft), stride=(1, hop))
        audio = F.fold((frames * hann).t()[None], **fold)[0, 0, 0]
        env = F.fold((hann * hann)[:, None].expand(n_fft, L)[None], **fold)[0, 0, 0]
        audio = torch.where(env > 1e-12, audio / env.clamp(min=1e-12), audio)
        pad = (n_fft - hop) // 2
        return audio[pad:pad + (L - 1) * hop + n_fft - 2 * pad]

    @staticmethod
    def _replicate(x, left: int, right: int):
        return F.pad(x.t()[None], (left, right), mode="replicate")[0].t() if left or right else x

    @staticmethod
    def _fir(x, filt, stride: int = 1):
        C, k = x.shape[-1], filt.shape[0]
        return F.conv1d(x.t()[None], filt.reshape(1, 1, k).expand(C, 1, k), stride=stride,
                        groups=C)[0].t()

    @staticmethod
    def _lowpass_taps(cutoff: float, device) -> torch.Tensor:
        """julius's windowed-sinc low-pass (zeros = 8)."""
        half = max(1, int(8.0 / cutoff / 2.0))
        t = np.arange(2 * half + 1, dtype=np.float64) - half
        x = 2.0 * cutoff * np.pi * t
        s = np.where(np.abs(x) < 1e-12, 1.0, np.sin(x) / np.where(x == 0, 1.0, x))
        n = 2 * half + 1
        hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
        f = 2.0 * cutoff * hann.astype(np.float32).astype(np.float64) * s
        return torch.from_numpy((f / f.sum()).astype(np.float32)).to(device)

    def _lowpass(self, x, cutoff: float):
        f = self._lowpass_taps(round(cutoff, 9), x.device)
        h = f.shape[0] // 2
        return self._fir(self._replicate(x, h, h), f)

    def _act(self, x, p: str):
        """Anti-aliased snake: 2x upsample, ADAA snake-beta, 2x downsample."""
        w = self.w
        fu, fd = w[f"{p}.up_filter"].reshape(-1), w[f"{p}.down_filter"].reshape(-1)
        k = fu.shape[0]
        pad = k // 2 - 1
        xp = self._replicate(x, pad, pad) * 2.0
        Tp, C = xp.shape
        st = torch.zeros(Tp * 2, C, device=x.device)
        st[0::2] = xp
        y = F.conv1d(st.t()[None], fu.flip(0).reshape(1, 1, k).expand(C, 1, k), padding=k - 1,
                     groups=C)[0].t()
        left, right = pad * 2 + (k - 2) // 2, pad * 2 + (k - 1) // 2
        y = y[left:(Tp - 1) * 2 + k - right]
        a = torch.exp(w[f"{p}.alpha"])
        inv = 1.0 / (2.0 * (torch.exp(w[f"{p}.beta"]) + 1e-9))
        prev = F.pad(y, (0, 0, 1, 0))[:-1]
        s, ad = y + prev, a * (y - prev)
        sinc = torch.where(ad.abs() < 1e-12, 1.0, torch.sin(ad) / torch.where(ad == 0, 1.0, ad))
        y = s * 0.5 + inv * (1.0 - torch.cos(a * s) * sinc)
        kd = fd.shape[0]
        y = self._replicate(y, kd // 2 - (1 if kd % 2 == 0 else 0), kd // 2)
        return self._fir(y, fd, 2)

    @staticmethod
    def _stuff(x, f: int):
        y = torch.zeros(x.shape[0] * f, x.shape[1], device=x.device)
        y[0::f] = x
        return y

    def _vocoder(self, mel):
        w = self.w
        r = mel
        for i in range(self.postnet_layers):
            p = f"mel_postnet.{i}"
            r = self._conv(r, w[f"{p}.conv.weight"], w[f"{p}.conv.bias"])
            r = F.layer_norm(r, r.shape[-1:], eps=self.eps) * w[f"{p}.norm.weight"] \
                + w[f"{p}.norm.bias"]
            if i + 1 < self.postnet_layers:
                r = torch.tanh(r)
        x0 = x = self._conv(mel + r, w["vocoder.conv_pre.weight"], w["vocoder.conv_pre.bias"])
        upp = 1
        for i, scale in enumerate(self.rates):
            upp *= scale
            p = f"vocoder.ups.{i}"
            y0 = self._conv(self._stuff(x0, upp), w[f"{p}.noise.weight"], w[f"{p}.noise.bias"])
            y0 = y0 - self._lowpass(y0, 0.5 / scale)
            y = self._lowpass(self._stuff(x, scale), 0.5 / scale)
            x = (y + y0) @ w[f"{p}.after.weight"][:, :, 0].t() + w[f"{p}.after.bias"]
            xs = torch.zeros_like(x)
            for rb in range(i * self.num_k, (i + 1) * self.num_k):
                q = f"vocoder.resblocks.{rb}"
                h = x
                for kk, dil in enumerate(RESBLOCK_DILATIONS):
                    t = self._act(h, f"{q}.acts.{2 * kk}")
                    t = self._conv(t, w[f"{q}.convs1.{kk}.weight"], w[f"{q}.convs1.{kk}.bias"], dil)
                    t = self._act(t, f"{q}.acts.{2 * kk + 1}")
                    h = self._conv(t, w[f"{q}.convs2.{kk}.weight"], w[f"{q}.convs2.{kk}.bias"]) + h
                xs = xs + h
            x = xs * (1.0 / max(1, self.num_k))
        x = self._act(x, "vocoder.activation_post")
        return torch.clamp(self._conv(x, w["vocoder.conv_post.weight"])[:, 0], -1.0, 1.0)

    @torch.no_grad()
    def decode(self, codes: list[int], emb: np.ndarray, anchor: int | None = None,
               peak_normalize: bool = True) -> np.ndarray:
        """Codes -> f32 audio (every valid sample), as the server's decode
        before its 16-bit quantization."""
        spec = self.spec(codes, emb, anchor)
        audio = self._istft(spec) if self.model_type == 0 else self._vocoder(spec)
        if peak_normalize:
            peak = audio.abs().max()
            if peak > 0.98:
                audio = audio * (0.95 / peak)
        return audio.float().cpu().numpy()
