from .convert import params_from_jax, tensor_from_numpy

__all__ = ["params_from_jax", "tensor_from_numpy"]
