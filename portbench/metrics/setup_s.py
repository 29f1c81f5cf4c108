"""Set-up: from the process's start to the window's opening (imports, the
card, weights, the index, warm-up, the traffic's lead-in or ramp)."""


def read(run):
    return run.setup_s
