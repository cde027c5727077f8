"""The 90th percentile (nearest rank) of the program's serve.queue spans
(submit's append to the scheduler taking the request) of the requests
submitted in the serve window, in ms (program spans, host clock)."""

import math

from qpbench import program_spans as P


def read(run):
    spans = P.recorded()
    w = spans and P.serve_window(spans, run)
    if not w:
        return None
    waits = sorted(P.ms(s) for s in P.window_requests(spans, w))
    return waits[math.ceil(0.9 * len(waits)) - 1] if waits else None
