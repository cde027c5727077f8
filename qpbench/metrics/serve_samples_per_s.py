"""PCM samples that reached the clients during the window, over the
window (host clock); a feed in flight at an end of the window counts by
the share of its time inside it (runners/serve.py::delivered)."""


def read(run):
    n = run.counts.get("serve_samples")
    return n / run.window_s if n and run.window_s > 0 else None
