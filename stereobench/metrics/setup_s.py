"""Seconds from the process's start to the first timed trigger or step."""


def read(window):
    return window.setup_s
