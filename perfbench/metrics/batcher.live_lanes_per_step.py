"""batcher.live_lanes_per_step: over the traced slice's span
(``Window.traced``), the chunk_dispatch ranges' (``chunk_dispatch steps=
width= live=``) steps-weighted mean of the live lanes a chunk served."""


def fields(name: str) -> dict:
    return {k: int(v) for k, v in (p.split("=") for p in name.split()[1:] if "=" in p)}


def read(w):
    w = w.traced
    if w is None or w.trace is None:
        return None
    steps = live = 0
    for _, _, name, _ in w.trace.ranges:
        if name.startswith("chunk_dispatch"):
            f = fields(name)
            steps += f["steps"]
            live += f["steps"] * f["live"]
    return live / steps if steps else None
