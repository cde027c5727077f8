"""Worker-pool fan-out over a file list (reference
src/utils/multi_process.py:13-26), the port's copy of
`qpnet_tpu/utils/multi_process.py`.

Workers start with the *spawn* method: a parent that holds a CUDA context
or any threads must not fork.  So `target_fn` is a module-level function,
and it and its arguments pickle.  n_jobs == 1 runs inline, in this
process, which is what a device backend needs: one process owns the card.
"""

from __future__ import annotations

import multiprocessing as mp

import numpy as np


def multi_processing(file_list, target_fn, n_jobs: int, *args) -> None:
    """Split file_list over n_jobs processes running
    target_fn(sub_list, *args); join all.  Never more workers than items:
    a spawned worker pays seconds of interpreter and import start-up."""
    n_jobs = max(1, min(int(n_jobs), len(file_list)))
    if n_jobs <= 1:
        target_fn(list(file_list), *args)
        return
    ctx = mp.get_context("spawn")
    processes = []
    for sub in np.array_split(file_list, n_jobs):
        p = ctx.Process(target=target_fn, args=(sub.tolist(),) + args)
        p.start()
        processes.append(p)
    for p in processes:
        p.join()
    failed = [p.exitcode for p in processes if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"{len(failed)} of {len(processes)} workers "
                           f"failed (exit codes {failed})")
