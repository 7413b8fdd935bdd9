"""Stereo pairs trained over the whole window's time: every step issued in
the window, fetch and augmentation included, to the synchronise that ends
it."""


def read(window):
    if window.units == 0:
        return None
    return window.units * window.pairs_per_unit / window.window_s
