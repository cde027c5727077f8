"""The mean train.step_fn span of the window's steps outside the traced
stretch: the host's enqueue of forward, backward and Adam, in ms (program
spans, host clock).  Near train_step_ms, the host sets the pace."""

from qpbench import program_spans as P


def read(run):
    spans = P.recorded()
    steps = P.train_steps(spans, run) if spans else []
    return P.mean(P.ms(f) for s in steps
                  for f in P.children(spans, s, "train.step_fn"))
