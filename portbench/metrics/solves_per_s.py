"""Solves completed in the window over the window's seconds (host clock,
all of the window's work and time)."""


def read(run):
    return len(run.solves) / run.window_s
