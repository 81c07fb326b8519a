from gvom_tpu_torch.oracle.numpy_ref import NumpyOracle

__all__ = ["NumpyOracle"]
