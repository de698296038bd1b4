"""K6_roofline: the least time of the vocoder's resblock layers that the
traced slice's span (``Window.traced``) needs of its finished requests
(``work.k6_request``: one decode at each request's valid length, spread
evenly over its synthesis), over the device time of K6 (``csrc/resblock.cu``'s
``resblock_kernel``) in the span."""

from perfbench import work
from perfbench.stats import generated, synth_interval


def read(w):
    w = w.traced
    v = w.cfg.get("vocoder") if w is not None else None
    if w is None or w.trace is None or not v:
        return None
    t = w.trace.kernel_seconds("resblock_kernel")
    if t <= 0:
        return None
    a, b = w.trace_window
    nbytes = flops = 0.0
    for rec in w.ok:
        share = work.overlap(*synth_interval(rec), a, b)
        if share:
            nb, fl = work.k6_request(w.cfg["codec"], v, generated(rec))
            nbytes += share * nb
            flops += share * fl
    return 100.0 * work.least_time(nbytes, flops, work.PEAK_FLOPS["float32"]) / t
