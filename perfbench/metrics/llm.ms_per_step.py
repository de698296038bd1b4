"""llm.ms_per_step: on the batcher's worker thread, each chunk's wall time
from the start of its chunk_dispatch to the end of its chunk_fetch (chunks
are read in the order they went out), summed over the traced slice's span
(``Window.traced``) and divided by the chunks' decode steps."""


def read(w):
    w = w.traced
    if w is None or w.trace is None:
        return None
    by_tid: dict = {}
    for a, b, name, tid in sorted(w.trace.ranges):
        if name.startswith(("chunk_dispatch", "chunk_fetch")):
            by_tid.setdefault(tid, []).append((a, b, name))
    wall = steps = 0.0
    for evs in by_tid.values():
        pending = []
        for a, b, name in evs:
            if name.startswith("chunk_dispatch"):
                s = dict(p.split("=") for p in name.split()[1:] if "=" in p)
                pending.append((a, int(s["steps"])))
            elif pending:
                a0, n = pending.pop(0)
                wall += b - a0
                steps += n
    return wall / 1e3 / steps if steps else None
