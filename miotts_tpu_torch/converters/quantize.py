"""Offline GGUF requantization — the llama.cpp ``llama-quantize`` analog
(miotts_tpu/convert/quantize.py, scripts/quantize_gguf.py).

    python -m miotts_tpu_torch.converters.quantize src.gguf dst.gguf [q4_0|q8_0]

Writes the same bytes as the JAX package's tool; its block quantizers are
the port's numpy copies (``gguf/quants.py``) of the JAX runtime's.

Rewrites an LLM GGUF's 2-D matmul weights to Q4_0 or Q8_0 block payloads so
a loader (the JAX package's native CPU engine, models/llm_cpu.py) reads them
without a per-process requantization pass. The KV
metadata section (tokenizer, hparams) is copied VERBATIM at the byte level —
no type round-trip, bit-identical — and non-matmul tensors (norms, biases,
1-D anything) pass through untouched.

Reference surface matched: the reference ships llama.cpp, whose
``llama-quantize`` tool produces the Q4_0/Q8_0 exports its CPU decode path
serves (``tts-mio-cli.cpp:1042-1058`` loads whatever quant the GGUF
carries).
"""

from __future__ import annotations

import argparse
import struct
from pathlib import Path

import numpy as np

from ..gguf.quants import (
    GGMLType, dequantize, q4_quantize_weights, q8_quantize_weights, type_nbytes)
from ..gguf.reader import GGUF_MAGIC, GGUFReader

_TARGETS = {
    "q4_0": GGMLType.Q4_0,
    "q8_0": GGMLType.Q8_0,
}


def _is_matmul_weight(info) -> bool:
    """2-D weights with a 32-divisible reduction dim requantize; everything
    else (norm gains, biases, rope tables) stays byte-identical."""
    return (len(info.shape) == 2 and info.shape[1] % 32 == 0
            and info.name.endswith(".weight")
            and "norm" not in info.name)


def requantize_gguf(src: str | Path, dst: str | Path, target: str = "q4_0",
                    verbose: bool = False) -> dict[str, int]:
    """Rewrite ``src`` into ``dst`` with matmul weights quantized to
    ``target``. Returns {ggml_type_name: tensor_count} of the output."""
    if target not in _TARGETS:
        raise ValueError(f"target={target!r} (want one of {list(_TARGETS)})")
    tgt_type = _TARGETS[target]
    quantize = {GGMLType.Q4_0: q4_quantize_weights,
                GGMLType.Q8_0: q8_quantize_weights}[tgt_type]

    r = GGUFReader(src)
    try:
        kv_raw = bytes(r._mm[24:r.kv_end])
        align = r.alignment
        # plan the output tensor table: (name, ne[], type, new raw bytes or
        # source span), recomputing offsets with the output alignment
        entries = []
        counts: dict[str, int] = {}
        for info in r.tensors.values():
            raw = r.tensor_raw(info.name)
            if _is_matmul_weight(info) and info.ggml_type != tgt_type:
                # np.array(..., copy=True) detaches the f32-passthrough
                # dequant view from the mmap so close() can release the map
                w = np.array(dequantize(raw, info.ggml_type,
                                        info.n_elements), copy=True)
                raw = quantize(w.reshape(info.shape).astype(
                    np.float32, copy=False))
                del w
                out_type = tgt_type
            else:
                raw = np.array(raw, copy=True)  # detach from the mmap
                out_type = info.ggml_type
            if verbose:
                print(f"  {info.name}: {info.ggml_type.name} -> "
                      f"{out_type.name} {info.shape}")
            counts[out_type.name] = counts.get(out_type.name, 0) + 1
            entries.append((info.name, info.shape, out_type, raw))

        with open(dst, "wb") as f:
            f.write(GGUF_MAGIC)
            f.write(struct.pack("<I", 3))
            f.write(struct.pack("<q", len(entries)))
            f.write(struct.pack("<q", r.n_kv))
            f.write(kv_raw)
            # tensor infos with recomputed offsets
            offset = 0
            infos_blob = bytearray()
            for name, shape, out_type, raw in entries:
                nb = name.encode("utf-8")
                infos_blob += struct.pack("<Q", len(nb)) + nb
                ne = tuple(reversed(shape))  # numpy convention -> ne[]
                infos_blob += struct.pack("<I", len(ne))
                for d in ne:
                    infos_blob += struct.pack("<Q", d)
                infos_blob += struct.pack("<I", int(out_type))
                infos_blob += struct.pack("<Q", offset)
                nbytes = type_nbytes(out_type, int(np.prod(shape)))
                assert nbytes == raw.size, (name, nbytes, raw.size)
                offset += (nbytes + align - 1) // align * align
            f.write(infos_blob)
            pos = f.tell()
            f.write(b"\x00" * ((pos + align - 1) // align * align - pos))
            for name, shape, out_type, raw in entries:
                f.write(raw.tobytes())
                pad = (-raw.size) % align
                if pad:
                    f.write(b"\x00" * pad)
    finally:
        r.close()
    return counts


def main(argv: list[str] | None = None) -> int:
    """scripts/quantize_gguf.py's command line."""
    p = argparse.ArgumentParser(description="Requantize an LLM GGUF's matmul weights "
                                            "(llama-quantize analog).")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("target", nargs="?", default="q4_0",
                   choices=["q4_0", "q8_0"])
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    counts = requantize_gguf(args.src, args.dst, args.target,
                             verbose=args.verbose)
    print(f"wrote {args.dst}: " +
          ", ".join(f"{n}x {t}" for t, n in sorted(counts.items())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
