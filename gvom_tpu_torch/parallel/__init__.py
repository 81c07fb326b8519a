from gvom_tpu_torch.parallel.sharding import batched_step, make_batched_step

__all__ = ["batched_step", "make_batched_step"]
