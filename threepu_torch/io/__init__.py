"""Weights and data in and out of the port."""

from threepu_torch.io.ply import (read_ply, read_ply_data,
                                  read_ply_with_color, save_ply,
                                  save_ply_property, save_ply_with_face,
                                  save_ply_with_face_property)
from threepu_torch.io.pointcloud import load, save
from threepu_torch.io.weights import (flatten_tree, load_jax_checkpoint,
                                      state_dict_from_jax)

__all__ = ["flatten_tree", "load", "load_jax_checkpoint", "read_ply",
           "read_ply_data", "read_ply_with_color", "save", "save_ply",
           "save_ply_property", "save_ply_with_face",
           "save_ply_with_face_property", "state_dict_from_jax"]
