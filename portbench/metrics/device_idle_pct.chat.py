"""Share of the traced window in which nothing ran on the device."""


def read(run):
    p = run.profile
    if p is None or p.window_us <= 0:
        return None
    return 100.0 * (1.0 - p.busy_us / p.window_us)
