"""2D spatial domain decomposition over device meshes."""

from cfd_tpu.parallel.mesh import factor_2d, grid_sharding, make_mesh, replicated
from cfd_tpu.parallel.halo import exchange_halos, global_max, global_sum
from cfd_tpu.parallel.mg_sharded import make_local_mg_solve
from cfd_tpu.parallel.sharded import ShardedCavity, gspmd_step

__all__ = [
    "factor_2d", "grid_sharding", "make_mesh", "replicated",
    "exchange_halos", "global_max", "global_sum",
    "make_local_mg_solve", "ShardedCavity",
    "gspmd_step",
]
