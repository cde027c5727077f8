"""PyTorch port: W2's plain version on the CPU at a length whose
back-pointers spill from the kernel's shared memory
(15,001 frames of 16 states),
against JAX's _viterbi, bit for bit.  The wrapper on CPU tensors runs the
plain version (no launch); chip_smoke.py phase 15 holds the card's spill
branch to that plain version.  test_torch_port_world_viterbi_spill_s7.py
holds the other case: each in a file of its own, so that the test workers
(loadfile) run them apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpnet_tpu.dsp.world import jax_f0
from qpnet_tpu_torch.dsp.world import device_f0
from qpnet_tpu_torch.ops import world_kernel as WK
from qpnet_tpu_torch.ops import world_kernel_cases as CASES
from torch_port_threads import one_thread  # noqa: F401

TC, UC = CASES.TRANSITION_COST, CASES.UNVOICED_COST


@pytest.mark.parametrize("F,K", [(15001, 15)])
def test_viterbi_past_shared_capacity_matches_jax(F, K):
    """At lengths whose back-pointers spill from W2's shared memory (75 s
    at S = 16, 60 s at S = 7), the wrapper on CPU tensors runs the plain
    version, whose states and f0 equal JAX's _viterbi."""
    assert WK.viterbi_spills(F, K) and not WK.viterbi_spills(F // 2, K // 2)
    refined, score = CASES.harvest_like_inputs(F + K, F, K)
    want = np.asarray(jax_f0._viterbi(jnp.asarray(refined),
                                      jnp.asarray(score), TC, UC))
    WK.reset_launch_count()
    got = device_f0._viterbi(torch.from_numpy(refined),
                             torch.from_numpy(score), TC, UC).numpy()
    assert WK.launch_count("viterbi") == 0
    np.testing.assert_array_equal(np.asarray(got, np.float32).view(np.int32),
                                  np.asarray(want, np.float32).view(np.int32))
    assert 0.2 < (got > 0).mean() < 0.95
