"""The share of the traced stretch's device-idle time (no kernel, copy or
set on the card) that lies inside the traced call's decode.prep span,
placed on the device trace's axis by the stretch's perf_counter at its
start, in % (program spans and the device trace)."""

from qpbench import program_spans as P


def read(run):
    spans = P.recorded()
    call = spans and P.stretch_call(spans, run)
    prep = call and P.children(spans, call, "decode.prep")
    if not prep or not run.trace.device:
        return None
    gaps = run.trace.gaps()
    idle = sum(s for s, _ in gaps)
    if idle <= 0:
        return None
    a = prep[0].t0_ns / 1e9 - run.trace.perf_at_start
    b = prep[0].t1_ns / 1e9 - run.trace.perf_at_start
    inside = sum(max(0.0, min(b, g + s) - max(a, g)) for s, g in gaps)
    return 100.0 * inside / idle
