"""Seconds from process start to the window's start."""


def read(run):
    return run["setup_s"]
