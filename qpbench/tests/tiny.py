"""A tiny configuration and small traffic for every cell, so that a whole
run fits a CPU test.

At this width the logits are about ten times smaller than at the cells'
own, so the gap limits of the generating cells are set here by the same
rule from readings at this size (six seeds each, sound runs' largest and
the control's smallest): decode bf16 0.0017 and 0.0246, limit 0.008;
decode w8a8 0.0077 and 0.0252, limit 0.015; serve 0.0044 and 0.0239,
limit 0.012.  The sampled tokens' excess over the entropy (six seeds)
reads 0.0029-0.0162 at this size, on some 300 tokens, too few to tell a
fault from a sound sampler (alter_tokens read 0.0063-0.0185), so its limit
here, 0.05, only has to hold sound runs; the greedy gap catches the faults.
The training cell's numbers are relative and keep their limits."""

import torch

from qpbench import harness

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=3, dilationF_repeat=1, dilationA_depth=2,
            dilationA_repeat=1, upsampling_factor=10, batch_length=200,
            max_length=400)

SMALL = {
    "default.decode.b20": dict(batch=3, batches_per_round=2,
                               seconds=[0.004, 0.008], check_utterances=3,
                               limit=0.008, check_sampled=3,
                               sampled_limit=0.05),
    "rd10.decode.w8a8.b7": dict(batch=2, batches_per_round=2,
                                seconds=[0.004, 0.008], check_utterances=2,
                                limit=0.015),
    "default.train.f32": dict(seconds=[0.02, 0.04], utterances=6),
    "default.serve.c32": dict(
        clients=4, seconds=[0.004, 0.008], check_streams=3,
        reply_delay_s=[0.05, 0.2], limit=0.012,
        prewarm=[1, 2, 4],
        service=dict(max_streams=64, maxd=32, gather_window_s=0.05,
                     min_chunk_samples=50, first_chunk_samples=0,
                     quantize="none", mode="argmax")),
}

CELLS = sorted(SMALL)


def run(name, seed=2 ** 31 + 77, seconds=1.0, trace=False, control=False,
        root=harness.ROOT, cfg=None, traffic=None):
    """One run of the cell on the CPU at the tiny size."""
    tr = dict(SMALL.get(name, {}))
    tr.update(traffic or {})
    return harness.run_cell(name, seed, seconds, trace, torch.device("cpu"),
                            root=root, control=control,
                            cfg_override={**TINY, **(cfg or {})},
                            traffic_override=tr)
