"""The share of the serve.queue spans of the requests submitted in the
serve window that ended with `joined` true: streams that joined a running
session at a feed boundary, not one that an idle device started, in %
(program spans, host clock)."""

from qpbench import program_spans as P


def read(run):
    spans = P.recorded()
    w = spans and P.serve_window(spans, run)
    if not w:
        return None
    reqs = P.window_requests(spans, w)
    if not reqs or any("joined" not in s.attrs for s in reqs):
        return None
    return 100.0 * sum(bool(s.attrs["joined"]) for s in reqs) / len(reqs)
