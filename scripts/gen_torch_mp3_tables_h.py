#!/usr/bin/env python3
"""Emit miotts_tpu_torch/runtime/native/mp3_tables.h, the ISO 11172-3
Layer III constants of the port's C++ mp3 decoder, from the port's own
table modules (runtime/mp3_tables.py and runtime/mp3.py), so the C++ and
numpy decoders share one source of truth.

    python scripts/gen_torch_mp3_tables_h.py

The header holds the same arrays, in the same order and with the same
values, as the JAX package's runtime/native/mp3_tables.h
(tests/test_torch_native.py holds the two equal value for value)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from miotts_tpu_torch.runtime import mp3 as M  # noqa: E402
from miotts_tpu_torch.runtime.mp3_tables import (  # noqa: E402
    CODE_OF, COUNT1A_COD, COUNT1A_LEN, HUFF_BIG, LINBITS, SYNTH_WIN_BASE)

OUT = ROOT / "miotts_tpu_torch" / "runtime" / "native" / "mp3_tables.h"


def carr(name: str, typ: str, vals, per: int = 12) -> str:
    lines = [f"static const {typ} {name}[{len(vals)}] = {{"]
    for i in range(0, len(vals), per):
        lines.append("    " + ", ".join(str(v) for v in vals[i:i + per]) + ",")
    lines.append("};")
    return "\n".join(lines)


def header() -> str:
    keys = list(HUFF_BIG)
    parts = ["// GENERATED by scripts/gen_torch_mp3_tables_h.py; do not edit.",
             "// ISO 11172-3 Layer III constants shared with runtime/mp3.py",
             "#pragma once", "#include <cstdint>"]
    # big codebooks: flattened lengths/codes and each book's offset
    lens_all, codes_all, offs, dims = [], [], [], []
    for k in keys:
        xlen, ylen, lens, codes = HUFF_BIG[k]
        offs.append(len(lens_all))
        dims.append((xlen, ylen))
        lens_all.extend(lens)
        codes_all.extend(codes)
    parts.append(carr("kHuffLens", "uint8_t", lens_all))
    parts.append(carr("kHuffCodes", "uint16_t", codes_all))
    parts.append(carr("kHuffOff", "int32_t", offs + [len(lens_all)]))
    parts.append(carr("kHuffXlen", "uint8_t", [d[0] for d in dims]))
    parts.append(carr("kHuffYlen", "uint8_t", [d[1] for d in dims]))
    parts.append(carr("kBookOf", "int8_t", [keys.index(CODE_OF[t]) if CODE_OF[t] is not None
                                            else -1 for t in range(32)]))
    parts.append(carr("kLinbits", "uint8_t", LINBITS))
    parts.append(carr("kCount1ALen", "uint8_t", COUNT1A_LEN))
    parts.append(carr("kCount1ACod", "uint8_t", COUNT1A_COD))
    parts.append(carr("kSynthWinBase", "int32_t", SYNTH_WIN_BASE))
    # scalefactor bands: 9 rates x (23 long + 14 short boundaries)
    rates = sorted(M.SFB)
    parts.append(carr("kSfbRates", "int32_t", rates))
    parts.append(carr("kSfbLong", "int16_t", [v for r in rates for v in M.SFB[r][0]]))
    parts.append(carr("kSfbShort", "int16_t", [v for r in rates for v in M.SFB[r][1]]))
    parts.append(carr("kPretab", "uint8_t", [int(v) for v in M.PRETAB]))
    parts.append(carr("kSlen1", "uint8_t", list(M.SLEN1)))
    parts.append(carr("kSlen2", "uint8_t", list(M.SLEN2)))
    parts.append(carr("kNrOfSfb", "uint8_t",  # [6][3][4]
                      [v for bn in M.NR_OF_SFB for cls in bn for v in cls]))
    return "\n\n".join(parts) + "\n"


def main() -> None:
    OUT.write_text(header())
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
