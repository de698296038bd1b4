"""Byte-level BPE tokenizer reconstructed from GGUF vocab metadata
(miotts_tpu/runtime/tokenizer.py).

Replaces the llama.cpp vocab/tokenizer usage in the reference
(``llama_tokenize``/``llama_token_to_piece``, tts-mio-cli.cpp:941-977,
mio-tts-lib.cpp:141-223). Supports the GPT-2-style BPE tokenizers used by
the Qwen-family MioTTS LLM: tokens + merges come from GGUF KVs
(``tokenizer.ggml.tokens`` / ``.merges`` / ``.token_type``); control/special
tokens (incl. the 12800 ``<|s_N|>`` audio tokens) are matched verbatim before
BPE; byte<->unicode mapping follows GPT-2's convention.
"""

from __future__ import annotations

import re

# token_type values (llama.cpp llama_token_type)
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4
TOKEN_TYPE_UNUSED = 5
TOKEN_TYPE_BYTE = 6

# GPT-2 pretokenizer regex (the qwen2 variant used by llama.cpp).
# Python re has no \p{L}/\p{N}; the Unicode-aware equivalents are
# [^\W\d_] (any letter) and \d (any decimal digit) — CJK/accented/Cyrillic
# text must survive pretokenization (Japanese is this model's primary
# language).
_PRETOKENIZE_RE = re.compile(
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
    r"(?:[^\w\r\n]|_)?[^\W\d_]+|\d{1,3}|"
    r" ?(?:[^\s\w]|_)+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    re.UNICODE,
)


def _bytes_to_unicode() -> dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_BYTE_TO_UNI = _bytes_to_unicode()
_UNI_TO_BYTE = {v: k for k, v in _BYTE_TO_UNI.items()}


class BPETokenizer:
    def __init__(
        self,
        tokens: list[str],
        merges: list[str],
        token_types: list[int] | None = None,
        bos_id: int | None = None,
        eos_id: int | None = None,
        add_bos: bool = False,
    ):
        self.tokens = tokens
        self.token_to_id = {t: i for i, t in enumerate(tokens)}
        self.token_types = token_types or [TOKEN_TYPE_NORMAL] * len(tokens)
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.add_bos = add_bos
        self.merge_ranks = {tuple(m.split(" ", 1)): i for i, m in enumerate(merges)}
        self.special_tokens = {
            t: i for i, t in enumerate(tokens)
            if self.token_types[i] in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED)
        }
        # longest-first matching for special tokens
        self._special_re = None
        if self.special_tokens:
            pats = sorted(self.special_tokens, key=len, reverse=True)
            self._special_re = re.compile("|".join(re.escape(t) for t in pats))

    @classmethod
    def from_gguf_kv(cls, kv: dict) -> "BPETokenizer":
        tokens = list(kv["tokenizer.ggml.tokens"])
        merges = list(kv.get("tokenizer.ggml.merges", []))
        types = kv.get("tokenizer.ggml.token_type")
        bos = kv.get("tokenizer.ggml.bos_token_id")
        eos = kv.get("tokenizer.ggml.eos_token_id")
        add_bos = bool(kv.get("tokenizer.ggml.add_bos_token", False))
        return cls(tokens, merges, list(types) if types is not None else None,
                   bos, eos, add_bos)

    # -- BPE core ---------------------------------------------------------------

    def _bpe(self, word: list[str]) -> list[str]:
        while len(word) >= 2:
            best = None
            best_rank = None
            for i in range(len(word) - 1):
                r = self.merge_ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            word = word[:best] + [word[best] + word[best + 1]] + word[best + 2:]
        return word

    def _encode_piece(self, text: str) -> list[int]:
        out: list[int] = []
        for m in _PRETOKENIZE_RE.findall(text):
            mapped = "".join(_BYTE_TO_UNI[b] for b in m.encode("utf-8"))
            for part in self._bpe(list(mapped)):
                tid = self.token_to_id.get(part)
                if tid is None:
                    # unmergeable: fall back to single byte tokens if present
                    for ch in part:
                        bid = self.token_to_id.get(ch)
                        if bid is not None:
                            out.append(bid)
                else:
                    out.append(tid)
        return out

    def encode(self, text: str, parse_special: bool = True, add_bos: bool | None = None) -> list[int]:
        ids: list[int] = []
        if add_bos if add_bos is not None else self.add_bos:
            if self.bos_id is not None:
                ids.append(self.bos_id)
        if parse_special and self._special_re is not None:
            pos = 0
            for m in self._special_re.finditer(text):
                if m.start() > pos:
                    ids.extend(self._encode_piece(text[pos:m.start()]))
                ids.append(self.special_tokens[m.group(0)])
                pos = m.end()
            if pos < len(text):
                ids.extend(self._encode_piece(text[pos:]))
        else:
            ids.extend(self._encode_piece(text))
        return ids

    # -- decode ------------------------------------------------------------------

    def token_piece(self, token_id: int, special: bool = True) -> str:
        """Raw piece text (llama_token_to_piece semantics): control tokens
        return their literal text only when ``special``; normal tokens are
        byte-decoded."""
        t = self.tokens[token_id]
        tt = self.token_types[token_id]
        if tt in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED, TOKEN_TYPE_UNKNOWN):
            return t if special else ""
        if tt == TOKEN_TYPE_BYTE:
            # "<0xNN>" form
            try:
                return chr(int(t[3:5], 16))
            except Exception:
                return t
        data = bytes(_UNI_TO_BYTE.get(ch, ord("?")) for ch in t)
        return data.decode("utf-8", errors="replace")

    def decode(self, ids: list[int], special: bool = False) -> str:
        """Detokenize. Byte-level pieces are accumulated and UTF-8 decoded
        together (a multibyte character spans several byte tokens)."""
        parts: list[str] = []
        buf = bytearray()

        def flush():
            if buf:
                parts.append(bytes(buf).decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            tt = self.token_types[i]
            t = self.tokens[i]
            if tt in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED, TOKEN_TYPE_UNKNOWN):
                flush()
                if special:
                    parts.append(t)
            elif tt == TOKEN_TYPE_BYTE:
                try:
                    buf.append(int(t[3:5], 16))
                except Exception:
                    flush()
                    parts.append(t)
            else:
                buf.extend(_UNI_TO_BYTE.get(ch, ord("?")) for ch in t)
        flush()
        return "".join(parts)

    def is_eog(self, token_id: int) -> bool:
        if self.eos_id is not None and token_id == self.eos_id:
            return True
        t = self.tokens[token_id]
        return t in ("<|im_end|>", "<|endoftext|>", "</s>", "<|eot_id|>", "<|end|>")
