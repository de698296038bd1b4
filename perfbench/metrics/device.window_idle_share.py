"""device.window_idle_share: the share of the whole window in which no
device interval of the program (``device:*``: chunk replays, prefill
groups, codec decodes) ran, in %."""

from perfbench.spans import busy_seconds, spans_of


def read(w):
    if not spans_of(w, prefix="device:") or w.seconds <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(w) / w.seconds)
