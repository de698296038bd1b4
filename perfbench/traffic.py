"""The one traffic generator: a mix's parameters (``workloads/<name>.json``)
and a cell's rate (``cells/<name>.json``) -> the run's schedule of requests.

Every seed gets the same set of sizes and arrivals in another order: the
count is the rate times the window; the gaps are the exponential
distribution's quantiles at (i + 0.5) / n, scaled to fill the window; the
code counts are the log-normal's quantiles, clipped; the streamed and the
greedy requests are fixed shares. The seed shuffles each of these, draws
each prompt's words and each request's sampler seed, and picks the sample
of finished requests that the correctness check judges.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np

WORDS = ("the", "quick", "brown", "fox", "jumps", "over", "a", "lazy", "dog", "while", "rain",
         "falls", "on", "quiet", "city", "streets", "and", "people", "hurry", "home", "after",
         "long", "day", "of", "work", "music", "plays", "softly", "in", "small", "cafe", "near",
         "river", "where", "old", "friends", "meet", "to", "talk", "about", "their", "plans",
         "for", "summer", "travel", "mountains", "sea", "bright", "morning", "light")


@dataclasses.dataclass
class Request:
    i: int
    due_s: float  # seconds after the window opens
    n_predict: int  # the codes asked for
    text: str
    stream: bool  # SSE /mio/tts/stream with stream_audio, else /mio/tts
    greedy: bool  # temp 0: its tokens are judged against the reference's logits
    seed: int  # the request's sampler seed

    def body(self, mix: dict) -> dict:
        s = mix["sampling"]
        b = {"text": self.text, "reference_key": "voice", "n_predict": self.n_predict,
             "temp": 0.0 if self.greedy else s["temp"], "top_k": s["top_k"], "seed": self.seed}
        if self.stream:
            b.update(stream_tokens=True, stream_audio=True)
        return b


def lognormal_quantiles(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    nd = statistics.NormalDist()
    q = [median * math.exp(sigma * nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.rint(q), lo, hi).astype(int)


def schedule(mix: dict, rate_rps: float, seconds: float, seed: int) -> list[Request]:
    """The requests due in a window of ``seconds`` at ``rate_rps``."""
    n = max(1, int(round(rate_rps * seconds)))
    rng = np.random.default_rng(seed)
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    gaps = rng.permutation(gaps) * (seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    c = mix["codes"]
    codes = rng.permutation(lognormal_quantiles(n, c["median"], c["sigma"], c["min"], c["max"]))
    n_stream = int(round(n * mix["stream_share"]))
    stream = rng.permutation(np.arange(n) < n_stream)
    greedy = np.zeros(n, bool)
    streams = np.flatnonzero(stream)
    n_greedy = int(round(len(streams) * mix["greedy_share_of_streams"]))
    greedy[rng.permutation(streams)[:n_greedy]] = True
    out = []
    for i in range(n):
        chars = int(round(mix["chars_per_audio_s"] * codes[i] / mix["codes_per_audio_s"]))
        words: list[str] = []
        while sum(len(w) + 1 for w in words) < chars:
            words.append(WORDS[int(rng.integers(len(WORDS)))])
        text = " ".join(words).capitalize() + "."
        out.append(Request(i, float(due[i]), int(codes[i]), text, bool(stream[i]),
                           bool(greedy[i]), int(rng.integers(1 << 31))))
    return out


def sample(reqs: list[Request], seed: int, check: dict) -> dict[str, list[int]]:
    """The requests the check judges, by role, each list holding the
    longest of its kind and the rest drawn from the seed: "llm" greedy
    streams (their tokens), "wav" /mio/tts requests (their WAV), "stream"
    streams (their stitched audio)."""
    rng = np.random.default_rng([seed, 1])
    pools = {"llm": [r for r in reqs if r.greedy], "wav": [r for r in reqs if not r.stream],
             "stream": [r for r in reqs if r.stream]}
    out = {}
    for role, pool in pools.items():
        if not pool:
            out[role] = []
            continue
        longest = max(pool, key=lambda r: (r.n_predict, -r.i))
        rest = [r.i for r in pool if r.i != longest.i]
        k = min(len(rest), check[role] - 1)
        out[role] = [longest.i] + sorted(int(x) for x in rng.choice(rest, size=k, replace=False))
    return out
