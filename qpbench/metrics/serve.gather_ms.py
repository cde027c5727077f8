"""The mean serve.gather span of the gathers that start in the serve
window: the scheduler's idle device holding a pending request until it
dispatches the group, the wait of the gather rule, in ms (program spans,
host clock)."""

from qpbench import program_spans as P


def read(run):
    spans = P.recorded()
    w = spans and P.serve_window(spans, run)
    if not w:
        return None
    return P.mean(P.ms(g) for g in P.named(spans, "serve.gather")
                  if w[0] <= g.t0_ns < w[1] and g.attrs.get("streams"))
