"""step_mfu: the whole step's share of the chip's peak while it works: the
FLOPs that the traced slice's span (``Window.traced``) needs, counted from
the configuration's shapes (``work.llm_flops`` over the bf16 peak,
``work.codec_flops`` over the f32 peak: the configuration's precisions;
each finished request's work taken as spread evenly over its interval),
over the span's device-busy seconds. Below the knee the work a window
needs is the offered load, so the share is taken over the time the card
was busy, which a faster step shortens."""

from perfbench import work
from perfbench.stats import generated, llm_interval, synth_interval


def read(w):
    w = w.traced
    if w is None or w.trace is None:
        return None
    busy = w.trace.busy_seconds()
    if busy <= 0:
        return None
    a, b = w.trace_window
    need = 0.0
    for rec in w.ok:
        n = generated(rec)
        need += (work.llm_flops(w.cfg["llm"], w.prompt_tokens[rec["i"]], n)
                 * work.overlap(*llm_interval(rec), a, b) / work.PEAK_FLOPS["bfloat16"])
        need += (work.codec_flops(w.cfg, n) * work.overlap(*synth_interval(rec), a, b)
                 / work.PEAK_FLOPS["float32"])
    return 100.0 * need / busy if need > 0 else None
