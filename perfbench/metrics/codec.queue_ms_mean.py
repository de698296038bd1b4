"""codec.queue_ms_mean: over the window's ``codec_queue`` spans (a codec
call's wait from ``CodecMicroBatcher.synthesize`` queueing it to the start
of its group's decode), their mean duration in ms."""

from perfbench.spans import spans_of


def read(w):
    d = [s.end - s.start for s in spans_of(w, "codec_queue")]
    return 1e3 * sum(d) / len(d) if d else None
