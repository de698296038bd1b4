"""latency_p50_ms: the median over every attempted request of the time from
its due time to its last audio byte (a failed request counts as
infinite)."""

from perfbench.stats import latencies_ms, percentile


def read(w):
    return percentile(latencies_ms(w), 50)
