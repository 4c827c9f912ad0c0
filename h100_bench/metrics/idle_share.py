"""Share of the device-only traced stretch's wall (host clock, synchronised
at both ends) in which no kernel, copy or set ran on the device, in %:
1 − (union of device intervals) / wall."""


def read(run):
    t = run.light
    return 100.0 * (1.0 - t.busy_s / t.wall_s) if t.device else None
