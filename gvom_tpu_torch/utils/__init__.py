from gvom_tpu_torch.utils.checkpoint import load_world, save_world
from gvom_tpu_torch.utils.metrics import StepMetrics
from gvom_tpu_torch.utils.profiling import annotate, profile_trace

__all__ = ["StepMetrics", "annotate", "profile_trace", "save_world", "load_world"]
