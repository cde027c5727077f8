"""The mean over the groups that start in the serve window of each group's
first serve.feed span (block assembly, priming, upload, K1, copy back), in
ms (program spans, host clock)."""

from qpbench import program_spans as P


def read(run):
    spans = P.recorded()
    w = spans and P.serve_window(spans, run)
    if not w:
        return None
    firsts = []
    for g in P.named(spans, "serve.group"):
        feeds = [f for f in P.children(spans, g, "serve.feed")
                 if f.attrs.get("index") == 0]
        if w[0] <= g.t0_ns < w[1] and feeds:
            firsts.append(P.ms(feeds[0]))
    return P.mean(firsts)
