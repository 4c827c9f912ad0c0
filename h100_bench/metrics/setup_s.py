"""Seconds from process start to the window's start: loading, building,
kernel builds and loads, the weights, the request pool and warm-up."""


def read(run):
    return run.setup_s
