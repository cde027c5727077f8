"""The mean first serve.write span of the streams submitted in the serve
window: the front end's mu-law decode, postfilter and socket write of a
stream's first chunk, on its connection's thread, in ms (program spans,
host clock)."""

from qpbench import program_spans as P


def read(run):
    spans = P.recorded()
    w = spans and P.serve_window(spans, run)
    if not w:
        return None
    rids = {s.rid for s in P.window_requests(spans, w)}
    return P.mean(P.ms(s) for s in P.named(spans, "serve.write")
                  if s.attrs.get("first") and s.rid in rids)
