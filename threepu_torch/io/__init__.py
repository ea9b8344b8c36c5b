"""Weights and data in and out of the port."""

from threepu_torch.io.weights import (flatten_tree, load_jax_checkpoint,
                                      state_dict_from_jax)

__all__ = ["flatten_tree", "load_jax_checkpoint", "state_dict_from_jax"]
