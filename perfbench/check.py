"""The comparison that decides ``correct``: what the timed path served,
against the plain reference (``reference/``), after the window has closed.

The readings, of which the cell's file (``limits``) names those compared,
each held to its limit there:

- ``llm_gap``: over the sampled greedy streams, the widest gap by which a
  served token's logit lies below the reference's best at its position
  (the reference runs once over each prompt with its served tokens);
- ``llm_gap_mean``: the same gaps' mean over every judged position (0 where
  the served token is the reference's best): a widest gap swings with the
  one closest tie, the mean grows with both how often and how far the
  served tokens miss, so it parts a lower precision from the stated one;
- ``llm_miss_share``: the share of judged positions whose served token is
  not the reference's best (read beside the others, not compared);
- ``wav_err``: over the sampled ``/mio/tts`` requests, the RMS of the
  served 16-bit WAV minus the reference's decode of its codes (peak
  normalized, quantized as the server does), over the reference's RMS;
- ``stream_err``: the same for the sampled streams' stitched audio against
  the reference's replay of the stream's feeds (``reference/stream.py``).

A sampled request that failed, or whose audio has another length, reads
infinity. The controls (``control.py``) read the same numbers with the
reference put in the program's place at a lower precision, or with the
program serving through its own lower-precision path.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from .gguf import Reader
from .reference.codec import Codec
from .reference.llm import LLM
from .reference.stream import ANCHOR, pcm16, stream_pcm
from .tokenizer import Tokenizer

NAMES = ("llm_gap", "llm_gap_mean", "llm_miss_share", "wav_err", "stream_err")
LLM_NAMES = NAMES[:3]  # read over the "llm" sample; the others over "wav" and "stream"


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: the best logit minus the logit of ``tokens``."""
    return logits.max(dim=-1).values - logits.gather(1, tokens[:, None])[:, 0]


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape or want.size == 0:
        return math.inf
    d = got.astype(np.float64) - want.astype(np.float64)
    return float(np.sqrt(np.mean(d * d)) / max(np.sqrt(np.mean(want.astype(np.float64) ** 2)),
                                              1e-9))


def served_wav(path: Path) -> np.ndarray:
    data = path.read_bytes()
    return np.frombuffer(data[44:], "<i2")


class Judge:
    """The references over one run's weights; the controls put a lower
    precision in the program's place: the LLM's matmul weights through each
    of ``quants``, the codec's matmuls and convs in TF32."""

    def __init__(self, paths: dict, device: torch.device, quants: tuple[str, ...] = ()):
        self.device = device
        self.llm = LLM(str(paths["llm"]), device)
        self.low = {q: LLM(str(paths["llm"]), device, quant=q) for q in quants}
        with Reader(paths["llm"]) as r:
            self.tok = Tokenizer.from_kv(r.kv)
        with Reader(paths["voice"]) as r:
            self.emb = r.tensor("mio.global_embedding").reshape(-1)
        self.codec = Codec(str(paths["codec"]), device)
        self.codes_of = self.tok.audio_codes()

    def _decode(self, codes, anchor, peak, tf32: bool) -> np.ndarray:
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            return self.codec.decode(codes, self.emb, anchor, peak)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def llm_gaps(self, text: str, tokens: list[int]) -> tuple[torch.Tensor, dict]:
        """(the served tokens' gap at each position, each control's: the gap
        of the token its lower precision puts first, at the same positions)."""
        ids = self.tok.prompt_ids(text)
        seq = ids + tokens[:-1]
        served = torch.tensor(tokens, device=self.device)
        with torch.no_grad():
            ref = self.llm.logits(seq)[len(ids) - 1:]
            ctl = {q: gaps(ref, low.logits(seq)[len(ids) - 1:].argmax(dim=-1)).cpu()
                   for q, low in self.low.items()}
            return gaps(ref, served).cpu(), ctl

    def codes(self, tokens: list[int]) -> list[int]:
        return [self.codes_of[t] for t in tokens if t in self.codes_of]

    def wav(self, codes: list[int], tf32: bool = False) -> np.ndarray:
        return pcm16(self._decode(codes, None, True, tf32))

    def stream(self, codes: list[int], tf32: bool = False) -> np.ndarray:
        return stream_pcm(lambda prefix: self._decode(prefix, ANCHOR, False, tf32), codes,
                          self.codec.spt)


def read_codes(path: Path) -> list[int]:
    return [int(x) for x in path.read_text().split()]


def llm_readings(g: list[torch.Tensor]) -> dict:
    """``llm_gap``, ``llm_gap_mean`` and ``llm_miss_share`` over the judged
    positions' gaps; infinity where there are none."""
    if not g:
        return {n: math.inf for n in LLM_NAMES}
    a = torch.cat(g).double()
    return {"llm_gap": float(a.max()), "llm_gap_mean": float(a.mean()),
            "llm_miss_share": float((a > 0).double().mean())}


def judge(j: Judge, reqs: dict, records: dict, sample: dict, keep: Path,
          control: bool = False) -> dict:
    """The run's readings (and with ``control`` the controls', as
    ``<name>.<quant>``, ``wav_err.tf32`` and ``stream_err.tf32``); each the
    worst (the LLM's: over every judged position) over its sample, and
    infinity where the sample is empty or a sampled request failed."""
    out = {"wav_err": 0.0 if sample["wav"] else math.inf,
           "stream_err": 0.0 if sample["stream"] else math.inf}
    if control:
        out.update({f"{n}.tf32": out[n] for n in ("wav_err", "stream_err")})

    def worst(name: str, v: float) -> None:
        out[name] = max(out[name], v)

    served: list[torch.Tensor] = []
    low: dict[str, list[torch.Tensor]] = {q: [] for q in j.low}
    failed = not sample["llm"]
    for i in sample["llm"]:
        rec = records.get(i)
        if not rec or not rec.get("ok"):
            failed = True
            continue
        g, ctl = j.llm_gaps(reqs[i].text, rec["tokens"])
        served.append(g)
        for q, v in ctl.items():
            low[q].append(v)
    out.update(llm_readings([] if failed else served))
    if control:
        for q, g in low.items():
            out.update({f"{n}.{q}": v for n, v in llm_readings(g).items()})
    for i in sample["wav"]:
        rec = records.get(i)
        if not rec or not rec.get("ok"):
            worst("wav_err", math.inf)
            continue
        codes = read_codes(keep / f"{i}.codes")
        want = j.wav(codes)
        worst("wav_err", rel_err(served_wav(keep / f"{i}.wav"), want))
        if control:
            worst("wav_err.tf32", rel_err(j.wav(codes, tf32=True), want))
    for i in sample["stream"]:
        rec = records.get(i)
        if not rec or not rec.get("ok"):
            worst("stream_err", math.inf)
            continue
        codes = j.codes(rec["tokens"])
        want = j.stream(codes)
        got = np.frombuffer((keep / f"{i}.pcm").read_bytes(), "<i2")
        worst("stream_err", rel_err(got, want))
        if control:
            worst("stream_err.tf32", rel_err(j.stream(codes, tf32=True), want))
    return {n: out[n] for n in NAMES} | {k: v for k, v in out.items() if k not in NAMES}
