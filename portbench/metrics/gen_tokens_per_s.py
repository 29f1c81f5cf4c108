"""Tokens of every content delta that arrived in the window, over the
window's seconds."""

from portbench.window import tokens_in_window


def read(run):
    return tokens_in_window(run) / (run.w1 - run.w0)
