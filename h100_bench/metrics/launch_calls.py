"""CUDA runtime and driver calls that put work on the device (kernel and
graph launches, asynchronous copies and sets) per request or step of the
device-only traced stretch: host calls, so that a graph launch counts once."""


def read(run):
    t = run.light
    return t.launch_calls / t.units if t.launch_calls else None
