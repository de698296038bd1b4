"""codec.ms_per_decode: the codec graphs' host time of a replay (copy in,
replay, read back) over the window: the change of ``codec_graph.codec``'s
replay_ms over the change of its replays."""


def read(w):
    c0, c1 = w.codec
    n = c1["replays"] - c0["replays"]
    return (c1["replay_ms"] - c0["replay_ms"]) / n if n else None
