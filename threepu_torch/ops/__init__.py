"""Geometric ops (port of :mod:`threepu.ops`).

Three modules hold a CUDA kernel beside its plain PyTorch version:
:mod:`~threepu_torch.ops.select`, :mod:`~threepu_torch.ops.fps` and
:mod:`~threepu_torch.ops.interlevel`; each keeps its kernel's launch
count on its ``KERNEL`` object.
"""
