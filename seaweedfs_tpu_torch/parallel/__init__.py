"""parallel — multi-device EC over a mesh of positions.

The counterpart of seaweedfs_tpu/parallel: stripes and shard outputs
split over a ('data', 'shard') mesh, the rebuild's contraction
XOR-folded over 'shard', K1 at every position; across processes on
``torch.distributed``; and MeshCodec, the volume server's
``ec_backend="mesh"``.
"""

from .mesh import make_mesh  # noqa: F401
from .mesh_codec import MeshCodec  # noqa: F401
from .multihost import init_distributed, multihost_ec_step  # noqa: F401
from .sharded_ec import (  # noqa: F401
    sharded_encode_fn, sharded_rebuild_fn, distributed_ec_step,
)
