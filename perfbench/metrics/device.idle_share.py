"""device.idle_share: the share of the traced slice's span
(``Window.traced``) in which no operation (kernel, copy or set) ran on the
card."""


def read(w):
    w = w.traced
    if w is None or w.trace is None or w.trace.seconds <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_seconds() / w.trace.seconds)
