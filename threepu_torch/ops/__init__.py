"""Geometric ops (port of :mod:`threepu.ops`).

Four modules hold a CUDA kernel beside its plain PyTorch version:
:mod:`~threepu_torch.ops.select`, :mod:`~threepu_torch.ops.fps`,
:mod:`~threepu_torch.ops.interlevel` and
:mod:`~threepu_torch.ops.chamfer`; each keeps its kernel's launch count on
its ``KERNEL`` object.
"""
