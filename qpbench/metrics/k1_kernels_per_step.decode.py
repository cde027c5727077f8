"""K1's CUDA kernels in the traced stretch (embed_kernel, prod_kernel,
sample_kernel, and the per-frame advance_kernel and per-call
set_ctx_kernel) over its steps, one sample_kernel a step."""

from qpbench.trace import short_name

K1 = ("embed_kernel", "prod_kernel", "sample_kernel", "advance_kernel",
      "set_ctx_kernel")


def read(run):
    if run.trace is None:
        return None
    names = [short_name(n) for n, _, _ in run.trace.device]
    k1 = [n for n in names if n.startswith(K1)]
    steps = sum(n.startswith("sample_kernel") for n in names)
    return len(k1) / steps if steps else None
