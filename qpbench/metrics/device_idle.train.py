"""The share of the traced stretch's wall in which no operation ran on
the card (torch.profiler: kernels, copies and sets), in %; only in the
train cells."""


def read(run):
    if run.trace is None or not run.trace.device or \
            "train_steps" not in run.counts:
        return None
    return run.trace.idle_share()
