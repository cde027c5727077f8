"""The mean decode.prep span of the window's calls outside the traced
stretch: batch_fast_generate from its entry to K1's first enqueue (weight
packing, ring priming, the host's input preparation and upload), in ms
(program spans, host clock)."""

from qpbench import program_spans as P


def read(run):
    spans = P.recorded()
    calls = P.window_calls(spans, run) if spans else []
    return P.mean(P.ms(p) for c in calls
                  for p in P.children(spans, c, "decode.prep"))
