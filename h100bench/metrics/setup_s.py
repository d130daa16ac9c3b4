"""Seconds from the process's start to the first request of the lead-in:
imports, weights, kernel builds and loads, session and warm-up."""

UNIT = "s"


def read(run):
    return run.setup_s
