"""The mean batch.window span (window_batches from resuming to a yield, on
the prefetch thread) ending between the start of the window's first step
and the end of its last, outside the traced stretch, in ms (program spans,
host clock)."""

from qpbench import program_spans as P


def read(run):
    spans = P.recorded()
    steps = P.train_steps(spans, run) if spans else []
    if not steps:
        return None
    a = min(s.t0_ns for s in steps)
    b = max(s.t1_ns for s in steps)
    st = P.stretch(run)
    return P.mean(P.ms(w) for w in P.named(spans, "batch.window")
                  if a <= w.t1_ns <= b
                  and (st is None or not st[0] <= w.t1_ns <= st[1]))
