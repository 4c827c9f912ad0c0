"""Utterances of the training steps completed in the window (batch ×
steps), over the window's seconds; the window closes on a synchronise."""


def read(run):
    return run.window.utterances / run.window.seconds
