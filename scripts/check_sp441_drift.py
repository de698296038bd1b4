#!/usr/bin/env python3
"""Whether the full-width 44.1 kHz codec's sp decode drifts in the JAX
package too, or only in the port: four decodes on the CPU.

    python3 scripts/check_sp441_drift.py [--codes 400] [--sp 2 4] [--out FILE]

Writes ``chip_smoke.py``'s full-width synthetic 44.1 kHz codec
(``testing.full_codec441_config()``, seed 3, no global encoder) with the
port's writer (the JAX writer writes the same bytes), then decodes its
codes (``chip_smoke.py``'s: ``RandomState(15)``, the first ``--codes`` of
400; 400 codes pad to bucket 512) with the embedding ``chip_smoke.py``
draws (``RandomState(0)``, 128 floats):

- JAX's sp decodes on a virtual CPU mesh of 8 host devices, and its
  mesh-less decode;
- the port's sp decodes on MIOTTS_LOGICAL_DEVICES=8 CPU ranks, and its
  mesh-less decode;
- the port's mesh-less decode with its GroupNorm statistics summed in f64
  (``chip_smoke.sp_floor``).

Prints each sp decode's max abs difference from its own package's
mesh-less decode, the two mesh-less decodes' difference, and the f64
floor, beside JAX's sp bar of 1e-4 (tests/test_sequence_parallel.py), as
lines and as one JSON object (also written to ``--out``). Imports JAX: it
is a CPU check beside the port, not part of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["MIOTTS_PLATFORM"] = "cpu"
os.environ["MIOTTS_LOGICAL_DEVICES"] = "8"
os.environ.setdefault("MIOTTS_COMPILE_CACHE", "off")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from chip_smoke import sp_floor  # noqa: E402
from miotts_tpu.pipeline import MioTTSPipeline as JaxPipeline  # noqa: E402
from miotts_tpu_torch.parallel.mesh import logical_devices  # noqa: E402
from miotts_tpu_torch.pipeline import MioTTSPipeline, pick_bucket  # noqa: E402
from miotts_tpu_torch.testing import (  # noqa: E402
    full_codec441_config, write_synthetic_miocodec_gguf)

BAR = 1e-4  # JAX's sp bar on audio (tests/test_sequence_parallel.py)


def max_abs(a: np.ndarray, b: np.ndarray) -> float:
    if a.shape != b.shape:
        raise SystemExit(f"shapes differ: {a.shape} vs {b.shape}")
    return float(np.abs(a - b).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codes", type=int, default=400, help="codes decoded (<= 400)")
    ap.add_argument("--sp", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = ap.parse_args()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    codes = np.random.RandomState(15).randint(0, 12800, 400)[:args.codes]
    emb = np.random.RandomState(0).randn(128).astype(np.float32)
    cpu = torch.device("cpu")
    out: dict = {"codes": int(args.codes)}
    with tempfile.TemporaryDirectory(prefix="miotts_sp441_") as d:
        path = str(Path(d) / "codec441.gguf")
        write_synthetic_miocodec_gguf(path, full_codec441_config(), seed=3,
                                      with_global_encoder=False)
        audio: dict[str, np.ndarray] = {}
        for sp in [None, *args.sp]:
            t0 = time.perf_counter()
            jp = JaxPipeline(path) if sp is None else JaxPipeline(
                path, sp_devices=jax.devices()[:sp])
            audio[f"jax sp={sp}"] = np.asarray(jp.synthesize(codes, emb).audio)
            del jp
            t1 = time.perf_counter()
            tp = MioTTSPipeline(path, cpu, sp_devices=None if sp is None
                                else logical_devices("cpu")[:sp])
            audio[f"torch sp={sp}"] = tp.synthesize(codes, emb).audio
            if sp is None:
                out["bucket"] = pick_bucket(len(codes), tp.buckets)
                out["torch f64 floor"] = sp_floor(tp, codes, emb, audio["torch sp=None"])
            del tp
            print(f"sp={sp}: JAX {t1 - t0:.1f}s, port {time.perf_counter() - t1:.1f}s",
                  file=sys.stderr, flush=True)
    out["samples"] = int(audio["jax sp=None"].size)
    out["mesh-less jax vs torch"] = max_abs(audio["jax sp=None"], audio["torch sp=None"])
    for sp in args.sp:
        for pkg in ("jax", "torch"):
            out[f"{pkg} sp={sp} vs mesh-less"] = max_abs(audio[f"{pkg} sp={sp}"],
                                                         audio[f"{pkg} sp=None"])
        out[f"jax vs torch sp={sp}"] = max_abs(audio[f"jax sp={sp}"], audio[f"torch sp={sp}"])
    for k, v in out.items():
        flag = "" if not isinstance(v, float) else (" (over 1e-4)" if v > BAR else "")
        print(f"{k}: {v}{flag}")
    line = json.dumps(out)
    print(line)
    if args.out is not None:
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
