"""ttfa_p50_ms: the median over every attempted stream of the time from its
due time to its first audio chunk (a failed stream counts as infinite)."""

from perfbench.stats import latencies_ms, percentile


def read(w):
    return percentile(latencies_ms(w, streams_only=True, first_audio=True), 50)
