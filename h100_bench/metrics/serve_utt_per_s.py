"""Utterances whose separated waveform reached the caller as numpy in the
window, over the window's seconds (its last request included)."""


def read(run):
    return run.window.utterances / run.window.seconds
