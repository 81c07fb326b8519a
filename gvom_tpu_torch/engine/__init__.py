from gvom_tpu_torch.engine.gvom import Gvom

__all__ = ["Gvom"]
