"""latency_p95_ms: the 95th percentile over every attempted request of the
time from its due time to its last audio byte (a failed request counts as
infinite)."""

from perfbench.stats import latencies_ms, percentile


def read(w):
    return percentile(latencies_ms(w), 95)
