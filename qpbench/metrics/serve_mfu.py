"""The model FLOPs of the samples delivered in the window (as decode_mfu
counts them, a frame's aux per 1/up of a sample) at the bf16 peak, or the
int8 peak for the main products under w8a8, over the window, in %."""

from qpbench import flops


def read(run):
    n = run.counts.get("serve_samples")
    if not n:
        return None
    fl = flops.decode_flops(run.cfg, n, n / run.cfg["upsampling_factor"])
    return flops.share(flops.seconds_at_peak(fl, run.counts["quantize"]),
                       run.window_s)
