"""Device time a traced step of the kernels launched inside the
benchmark's fetch + augment span (ms): the resident fetch and the
augmentation on the card."""


def read(window):
    tr = window.trace
    if tr is None:
        return None
    return tr.span_device_s("bench.fetch and augment") / tr.units * 1e3
