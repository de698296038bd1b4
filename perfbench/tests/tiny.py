"""A tiny cell for the CPU tests: the harness's checkout layout in a
temporary directory, pointing at ``tiny_wave.json`` or ``tiny_mel.json``,
with a short mix and limits set for those sizes (clean CPU runs read
llm_gap 0-0.06, llm_gap_mean 0-0.0011, wav_err and stream_err ~2-4e-5)."""

from __future__ import annotations

import json
from pathlib import Path

from perfbench import harness

HERE = Path(__file__).resolve().parent
LIMITS = {"llm_gap": 0.25, "llm_gap_mean": 0.01, "wav_err": 1e-3, "stream_err": 1e-3}


def tiny_bench(root: Path, config: str = "tiny_wave") -> harness.Bench:
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "tests", "file": str(HERE / f"{config}.json"),
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = [{"name": "tiny.open", "config": "tiny", "traffic": "open_mixed",
                           "chips": 1, "why": "tests"}]
    for kind in ("end_to_end", "per_layer"):  # the wave cell's metrics
        bench[kind] = [m for m in bench[kind] if "wave24k.open" in m.get("workloads", ["wave24k.open"])]
        for m in bench[kind]:
            m.pop("workloads", None)
    root.mkdir(parents=True, exist_ok=True)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((harness.PKG / "workloads" / "open_mixed.json").read_text())
    mix["codes"] = {"median": 30, "sigma": 0.6, "min": 10, "max": 60}
    mix["check"] = {"llm": 3, "wav": 2, "stream": 2}
    return harness.Bench("tiny.open", root=root, mix=mix,
                         params={"rate_rps": 2.0, "limits": LIMITS})
