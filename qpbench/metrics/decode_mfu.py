"""The model FLOPs of the window's useful decode samples (qpbench.flops:
per sample the residual layers' products and the post-net, per frame the
aux projection) at the peaks of the configuration's product types, over
the window's wall time, in %."""

from qpbench import flops


def read(run):
    n = run.counts.get("decode_useful_samples")
    if not n:
        return None
    fl = flops.decode_flops(run.cfg, n, run.counts["decode_frames"])
    return flops.share(flops.seconds_at_peak(fl, run.counts["quantize"]),
                       run.window_s)
