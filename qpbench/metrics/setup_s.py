"""Seconds from the process's start to the window's: imports, the CUDA
context, weights, kernel builds or loads, warm-up (host clock)."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
