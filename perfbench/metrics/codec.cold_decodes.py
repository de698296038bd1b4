"""codec.cold_decodes: codec decodes in the window that ran eagerly or
captured a graph (``codec_graph.codec``'s eager + captures): 0 when the
warm-up covers the traffic."""


def read(w):
    c0, c1 = w.codec
    return float((c1["eager"] - c0["eager"]) + (c1["captures"] - c0["captures"]))
