"""batcher.attach_ms_mean: over the window's text requests, the mean time
in ms from the start of a request's ``lane_wait`` (``batcher.submit``
waiting for a free lane) to the end of its ``attach_wait`` (the worker's
attach of its lane): the lane, the prefill queue, the prefill and the
attach together. A request whose attach falls after the window is left
out."""

from perfbench.spans import spans_of


def read(w):
    attached = {s.rids[0]: s.end for s in spans_of(w, "attach_wait") if s.rids}
    d = [attached[s.rids[0]] - s.start for s in spans_of(w, "lane_wait")
         if s.rids and s.rids[0] in attached]
    return 1e3 * sum(d) / len(d) if d else None
