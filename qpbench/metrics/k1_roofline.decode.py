"""K1's share of its roofline in the traced stretch: the least time of the
profiled call's useful work (qpbench.flops.k1_bound: bytes once over HBM,
useful operations at the type's peaks), pro-rated to the stretch's steps
(one sample_kernel a step) out of the call's padded steps, over the union
of K1's kernel spans in the stretch, in %."""

from qpbench import flops
from qpbench.trace import Trace, short_name

K1 = ("embed_kernel", "prod_kernel", "sample_kernel", "advance_kernel",
      "set_ctx_kernel")


def read(run):
    call = run.counts.get("stretch_call")
    if run.trace is None or not call:
        return None
    k1 = run.trace.named(lambda n: short_name(n).startswith(K1))
    steps = sum(short_name(n).startswith("sample_kernel") for n, _, _ in k1)
    busy = Trace.busy_of(k1)
    if not steps or busy <= 0:
        return None
    bound, _ = flops.k1_bound(run.cfg, call["B"], run.counts["maxd"],
                              call["useful_samples"], call["frames"],
                              run.counts["quantize"])
    return flops.share(bound * steps / call["padded_steps"], busy)
