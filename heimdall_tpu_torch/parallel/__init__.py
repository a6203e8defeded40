"""Multi-device inspection on torch.distributed (port of
heimdall_tpu/parallel): meshes of ("data", "spatial") over the ranks of a
world, one process per rank (parallel/launch.py starts a world on one
machine), the sharded inspection, line and data-parallel steps, and the
band kernels across devices (tiled_sp)."""

from heimdall_tpu_torch.parallel.mesh import make_mesh, mesh_info
from heimdall_tpu_torch.parallel.sharding import (
    batch_sharding,
    replicated_sharding,
    shard_batch,
)
from heimdall_tpu_torch.parallel.inspect_step import (
    make_sharded_inspection_step,
    make_line_step,
    make_pallas_data_parallel_step,
)
from heimdall_tpu_torch.parallel import multihost
