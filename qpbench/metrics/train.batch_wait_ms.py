"""Mean wall time of the next() that train_loop makes on its batch
iterator each step of the window (the benchmark's span around it, host
clock)."""


def read(run):
    w = run.counts.get("batch_wait_s")
    return sum(w) / len(w) * 1e3 if w else None
