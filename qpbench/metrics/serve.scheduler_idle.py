"""The share of the serve window that no serve.group span covers: the time
the card sits idle between groups, in % (program spans, host clock)."""

from qpbench import program_spans as P


def read(run):
    spans = P.recorded()
    w = spans and P.serve_window(spans, run)
    if not w:
        return None
    a, b = w
    busy, end = 0.0, a
    for g in sorted(P.named(spans, "serve.group"), key=lambda s: s.t0_ns):
        lo, hi = max(g.t0_ns, end), min(g.t1_ns, b)
        if hi > lo:
            busy += hi - lo
        end = max(end, min(g.t1_ns, b))
    return 100.0 * (1.0 - busy / (b - a))
