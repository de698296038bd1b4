"""engine.wait_ms_mean: over the window's finished /mio/tts requests, the
mean of the client's latency (from due) less the server's own llm_ms and
synth_ms: slot and queue waits, HTTP, the WAV's write and read."""


def read(w):
    v = [(r["done"] - r["due"]) * 1e3 - r["llm_ms"] - r["synth_ms"]
         for r in w.records.values()
         if r.get("ok") and not r["stream"] and r.get("llm_ms") is not None]
    return sum(v) / len(v) if v else None
