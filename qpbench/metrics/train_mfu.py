"""3 x the forward's model FLOPs a step (all B x T samples the step
computes) over the step time (train_step_ms) and the TF32 peak, in %."""

from qpbench import flops


def read(run):
    n = run.counts.get("train_steps")
    if not n:
        return None
    return flops.train_mfu(run.cfg, run.counts["train_B"],
                           run.counts["train_T"], run.window_s / n)
