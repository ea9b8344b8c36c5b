"""Weights, checkpoints and data in and out of the port."""

from threepu_torch.io.checkpoint import (export_reference_state, import_pth,
                                         load_checkpoint, load_opt_state,
                                         save_checkpoint, save_pth,
                                         save_train_checkpoint)
from threepu_torch.io.ply import (read_ply, read_ply_data,
                                  read_ply_with_color, save_ply,
                                  save_ply_property, save_ply_with_face,
                                  save_ply_with_face_property)
from threepu_torch.io.pointcloud import load, save
from threepu_torch.io.weights import (flatten_tree, load_jax_checkpoint,
                                      state_dict_from_jax)

__all__ = ["export_reference_state", "flatten_tree", "import_pth", "load",
           "load_checkpoint", "load_jax_checkpoint", "load_opt_state",
           "read_ply", "read_ply_data", "read_ply_with_color", "save",
           "save_checkpoint", "save_ply", "save_ply_property",
           "save_ply_with_face", "save_ply_with_face_property", "save_pth",
           "save_train_checkpoint", "state_dict_from_jax"]
