"""Data, tensor, sequence and pipeline parallelism over torch.distributed:
the (dp, tp, sp) and (dp, pp) meshes, the multi-host world with its
gradient, tp, sp and pp groups, and the dryrun."""

from qpnet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, shard_batch,
)
from qpnet_tpu_torch.parallel.distributed import (  # noqa: F401
    global_min_and_any, global_min_scalar, host_shard_list,
    initialize_multihost,
    make_global_batch,
)
