from .convert import (params_from_jax, params_to_jax, state_from_jax, state_to_jax,
                      tensor_from_numpy)

__all__ = ["params_from_jax", "params_to_jax", "state_from_jax", "state_to_jax",
           "tensor_from_numpy"]
