"""codec.device_ms_per_decode: over the window's codec decodes, the mean
device time of one (``device:codec_group``, a pair of CUDA events on the
codec stream from the first copy-in to the replay's end), in ms."""

from perfbench.spans import spans_of


def read(w):
    d = [s.end - s.start for s in spans_of(w, "device:codec_group")]
    return 1e3 * sum(d) / len(d) if d else None
