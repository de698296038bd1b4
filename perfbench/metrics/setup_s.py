"""setup_s: seconds from the process's start to the window's opening
(weights written, server built, warm-up complete), on the host's clock."""


def read(w):
    return w.setup_s
