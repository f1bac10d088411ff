"""Sharding over the ranks of a torch.distributed process group — the port
of scs_tpu.parallel: a batch of problems split over the ranks
(`shard_batched_mats`, `sharded_batch_solve`), and one problem whose A is
split by rows (`ShardedSCS`; the CG alone: `sharded_cg_solve`)."""

from .mesh import make_mesh, shard_batched_mats, sharded_batch_solve  # noqa: F401
from .sharded import ShardedSCS  # noqa: F401
from .sharded_cg import sharded_cg_solve, sharded_normal_matvec  # noqa: F401
