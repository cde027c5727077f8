"""Wall time of the window (host clock, each end after a synchronize) over
the train_loop steps completed in it."""


def read(run):
    n = run.counts.get("train_steps")
    return run.window_s / n * 1e3 if n else None
