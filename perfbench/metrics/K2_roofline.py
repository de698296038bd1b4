"""K2_roofline: the least time of the decode attention that the traced
slice's span (``Window.traced``) needs (``work.k2_need``: each finished
request's tokens taken as spread evenly over its generation), over the
device time of K2 (``csrc/decode_attention.cu``'s
``decode_attention_kernel``) in the span."""

from perfbench import work
from perfbench.stats import generated, llm_interval


def read(w):
    w = w.traced
    if w is None or w.trace is None:
        return None
    t = w.trace.kernel_seconds("decode_attention_kernel")
    if t <= 0:
        return None
    a, b = w.trace_window
    c = w.cfg["llm"]
    nbytes = flops = 0.0
    for rec in w.ok:
        n = generated(rec)
        t0, t1 = llm_interval(rec)
        if t1 <= t0 or t1 < a or t0 > b:
            continue
        k0 = n * max(0.0, (a - t0) / (t1 - t0))
        k1 = n * min(1.0, (b - t0) / (t1 - t0))
        nb, fl = work.k2_need(c, w.prompt_tokens[rec["i"]], k0, k1)
        nbytes += nb
        flops += fl
    return 100.0 * work.least_time(nbytes, flops, work.PEAK_FLOPS["bfloat16"]) / t
