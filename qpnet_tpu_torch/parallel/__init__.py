"""Data and tensor parallelism over torch.distributed: the (dp, tp) mesh,
the multi-host world with its dp and tp groups, and the dryrun (ROADMAP.md,
Queue 1: sp and pp follow)."""

from qpnet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, shard_batch,
)
from qpnet_tpu_torch.parallel.distributed import (  # noqa: F401
    global_min_and_any, global_min_scalar, host_shard_list,
    initialize_multihost,
    make_global_batch,
)
