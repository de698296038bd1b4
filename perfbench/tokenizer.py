"""The LLM's byte-level BPE tokenizer and chat template, the benchmark's own
frozen copy: the reference needs each prompt's ids, and the work counts
need its length in tokens.

Tokens, merges and types come from the GGUF's ``tokenizer.ggml.*`` KVs;
control and user-defined tokens match verbatim before BPE, longest first;
bytes map to characters by GPT-2's table.
"""

from __future__ import annotations

import re

CHAT_TEMPLATE = "<|im_start|>user\n{text}<|im_end|>\n<|im_start|>assistant\n"
TOKEN_TYPE_NORMAL, TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED = 1, 3, 4
AUDIO_TOKEN = re.compile(r"^<\|s_(\d+)\|>$")

# GPT-2's pretokenizer (the qwen2 variant), letters as [^\W\d_]
_PRETOKENIZE = re.compile(
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|(?:[^\w\r\n]|_)?[^\W\d_]+|\d{1,3}|"
    r" ?(?:[^\s\w]|_)+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+", re.UNICODE)


def bytes_to_unicode() -> dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_BYTE_TO_UNI = bytes_to_unicode()


class Tokenizer:
    def __init__(self, tokens: list[str], merges: list[str], types: list[int]):
        self.tokens = tokens
        self.ids = {t: i for i, t in enumerate(tokens)}
        self.ranks = {tuple(m.split(" ", 1)): i for i, m in enumerate(merges)}
        special = [t for t, ty in zip(tokens, types)
                   if ty in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED)]
        self._special = (re.compile("|".join(re.escape(t) for t in sorted(special, key=len,
                                                                            reverse=True)))
                         if special else None)

    @classmethod
    def from_kv(cls, kv: dict) -> "Tokenizer":
        tokens = list(kv["tokenizer.ggml.tokens"])
        types = list(kv.get("tokenizer.ggml.token_type", [TOKEN_TYPE_NORMAL] * len(tokens)))
        return cls(tokens, list(kv.get("tokenizer.ggml.merges", [])), types)

    def _bpe(self, word: list[str]) -> list[str]:
        while len(word) >= 2:
            pairs = [(self.ranks.get((a, b)), i) for i, (a, b) in enumerate(zip(word, word[1:]))]
            pairs = [p for p in pairs if p[0] is not None]
            if not pairs:
                break
            i = min(pairs)[1]
            word = word[:i] + [word[i] + word[i + 1]] + word[i + 2:]
        return word

    def _piece(self, text: str) -> list[int]:
        out: list[int] = []
        for m in _PRETOKENIZE.findall(text):
            for part in self._bpe([_BYTE_TO_UNI[b] for b in m.encode("utf-8")]):
                if part in self.ids:
                    out.append(self.ids[part])
                else:
                    out.extend(self.ids[ch] for ch in part if ch in self.ids)
        return out

    def encode(self, text: str) -> list[int]:
        """Ids of ``text`` with special tokens parsed; no BOS (the LLM's GGUF
        says ``add_bos_token`` false)."""
        if self._special is None:
            return self._piece(text)
        ids, pos = [], 0
        for m in self._special.finditer(text):
            ids += self._piece(text[pos:m.start()]) + [self.ids[m.group(0)]]
            pos = m.end()
        return ids + self._piece(text[pos:])

    def prompt_ids(self, text: str) -> list[int]:
        return self.encode(CHAT_TEMPLATE.format(text=text))

    def audio_codes(self) -> dict[int, int]:
        """Token id -> audio code, for the ``<|s_N|>`` tokens, N < 12800."""
        out = {}
        for tid, t in enumerate(self.tokens):
            m = AUDIO_TOKEN.match(t)
            if m and int(m.group(1)) < 12800:
                out[tid] = int(m.group(1))
        return out
