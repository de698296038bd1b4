"""ttfa_p95_ms: the 95th percentile over every attempted stream of the time
from its due time to its first audio chunk (a failed stream counts as
infinite). A per-layer number: a window holds about a hundred streams, too
few beyond the 95th percentile for a bound."""

from perfbench.stats import latencies_ms, percentile


def read(w):
    return percentile(latencies_ms(w, streams_only=True, first_audio=True), 95)
