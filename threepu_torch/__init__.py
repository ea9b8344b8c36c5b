"""threepu_torch — the PyTorch/CUDA port of :mod:`threepu`.

Progressive point-cloud upsampling (3PU) on an NVIDIA Hopper GPU.  The
JAX package :mod:`threepu` is the reference: module names mirror it, the
public functions keep its channels-last ``(B, N, C)`` layout, and the
networks use the reference's state-dict names so trained JAX weights
load with ``strict=True`` (:mod:`threepu_torch.io.weights`).

Plain tensor code is PyTorch.  Every op that :mod:`threepu` runs as a
Pallas kernel on the TPU is a hand-written CUDA kernel here
(``threepu_torch/csrc``), built at first use by
:mod:`threepu_torch._build`.  Each kernel wrapper launches its kernel on
a CUDA tensor and runs the plain PyTorch version of the same function
on a CPU tensor; there is no fallback from one to the other.

Patch parallelism over several GPUs (one process a card, ``nccl``; or
CPU processes under ``gloo``) is :mod:`threepu_torch.parallel`, the
counterpart of :mod:`threepu.parallel`.

This package imports ``torch`` and ``numpy`` only — never ``jax`` or
``threepu`` — so it runs on machines without JAX.
"""

from threepu_torch.device import require_cuda, set_fp32_policy

__all__ = ["require_cuda", "set_fp32_policy"]
