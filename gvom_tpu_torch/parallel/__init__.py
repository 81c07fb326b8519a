from gvom_tpu_torch.parallel.mesh import Mesh, factor_devices, init_distributed, make_mesh
from gvom_tpu_torch.parallel.sharding import batched_step, gather_world, make_batched_step, shard_batch, shard_world

__all__ = ["batched_step", "make_batched_step", "shard_batch", "shard_world", "gather_world", "Mesh",
           "factor_devices", "init_distributed", "make_mesh"]
