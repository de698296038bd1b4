"""llm.device_ms_per_step: over the window's chunks, the device time of
their replays (``device:chunk_dispatch``, a pair of CUDA events on the dp
rank's worker stream around the replay) over their decode steps, in ms."""

from perfbench.spans import spans_of


def read(w):
    spans = spans_of(w, "device:chunk_dispatch")
    steps = sum(s.attrs.get("steps", 0) for s in spans)
    return 1e3 * sum(s.end - s.start for s in spans) / steps if steps else None
