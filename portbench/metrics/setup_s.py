"""Seconds from the process's start to the first timed frame (host
clock)."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
