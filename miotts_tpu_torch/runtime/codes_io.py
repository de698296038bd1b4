"""Audio-code text I/O with ``<|s_N|>`` token parsing
(miotts_tpu/runtime/codes_io.py).

Matches the reference's parser exactly (mio-tts-lib.cpp:79-139,225-286):
leading/trailing ASCII punctuation is stripped (preserving '<', '-', '>' and
trailing digits), ``<|s_N|>`` unwraps to N, bare integers pass through, and
codes must be in [0, 12799].
"""

from __future__ import annotations

from pathlib import Path

from .. import MIO_CODE_MAX, MIO_CODE_MIN


def _strip_ascii_punct(s: str) -> str:
    def is_punct(c: str) -> bool:
        return 33 <= ord(c) <= 126 and not c.isalnum()

    while s and is_punct(s[0]) and s[0] not in "<-":
        s = s[1:]
    while s and is_punct(s[-1]) and s[-1] != ">" and not s[-1].isdigit():
        s = s[:-1]
    return s


def parse_code_token(raw: str) -> int | None:
    token = _strip_ascii_punct(raw)
    if not token:
        return None
    if token.startswith("<|s_") and len(token) > 6 and token.endswith("|>"):
        token = token[4:-2]
    try:
        v = int(token, 10)
    except ValueError:
        return None
    if not (-(2 ** 31) <= v < 2 ** 31):
        return None
    return v


def parse_codes_text(text: str) -> list[int]:
    """Parse whitespace/CSV-separated codes; raises on malformed or
    out-of-range entries (load_codes_text semantics)."""
    out: list[int] = []
    for tok in text.replace(",", " ").split():
        code = parse_code_token(tok)
        if code is None:
            raise ValueError(f"failed to parse code token: {tok}")
        if code < MIO_CODE_MIN or code > MIO_CODE_MAX:
            raise ValueError("code id out of range in input")
        out.append(code)
    if not out:
        raise ValueError("codes input is empty")
    return out


def load_codes(path: str | Path) -> list[int]:
    return parse_codes_text(Path(path).read_text(encoding="utf-8"))


def save_codes(path: str | Path, codes: list[int]) -> None:
    if not codes:
        raise ValueError("codes are empty")
    Path(path).write_text("".join(f"{c}\n" for c in codes), encoding="utf-8")
