"""Useful samples (F_i * up - 1 of every finished utterance) of the
window's whole batch_fast_generate calls over the window's wall time, from
the first call's start to the last call's end (host clock)."""


def read(run):
    n = run.counts.get("decode_useful_samples")
    return n / run.window_s if n and run.window_s > 0 else None
