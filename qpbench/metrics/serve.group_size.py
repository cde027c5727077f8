"""The mean streams of the serve.group spans that start and end in the
serve window: serve.streams_per_group's rule, read where the service makes
the group (program spans, host clock)."""

from qpbench import program_spans as P


def read(run):
    spans = P.recorded()
    w = spans and P.serve_window(spans, run)
    if not w:
        return None
    return P.mean(g.attrs["streams"] for g in P.named(spans, "serve.group")
                  if w[0] <= g.t0_ns and g.t1_ns <= w[1])
