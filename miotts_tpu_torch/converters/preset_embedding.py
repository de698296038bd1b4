"""Speaker-embedding preset (.pt / .npz) -> *.emb.gguf
(scripts/convert_preset_embedding_to_gguf.py).

    python -m miotts_tpu_torch.converters.preset_embedding preset.pt -o voice.emb.gguf

Parity with the reference converter: tensor 'mio.global_embedding', KV
'mio.embedding.dim' (mio-tts-lib.cpp:288-347 load contract)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..gguf.writer import save_embedding_gguf
from .miocodec import _load_embedding


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Convert a speaker-embedding preset "
                                            "(.pt / .npz) to *.emb.gguf.")
    p.add_argument("embedding", help="path to .pt or .npz preset embedding")
    p.add_argument("-o", "--outfile", required=True)
    args = p.parse_args(argv)
    emb = _load_embedding(Path(args.embedding))
    save_embedding_gguf(args.outfile, emb)
    print(json.dumps({"outfile": str(Path(args.outfile).resolve()),
                      "embedding_dim": int(emb.size)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
