"""Device selection and the float32 precision policy.

Geometry (distances, kNN ranking, FPS) must stay in full float32: the
JAX package forces ``Precision.HIGHEST`` for it
(``threepu/ops/distances.py``).  On the GPU the counterpart is to keep
TF32 off for both matmuls and cuDNN convolutions.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def set_fp32_policy() -> None:
    """Keep float32 matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_cuda() -> torch.device:
    """The current CUDA device, with the float32 policy applied.

    Raises ``RuntimeError`` when no GPU is visible: the port's GPU entry
    points never fall back to the CPU.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("threepu_torch: no CUDA device is visible")
    set_fp32_policy()
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> :func:`require_cuda` (the card, or an error); any
    other value -> that device, a CUDA one checked by
    :func:`require_cuda` first."""
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    return dev


def card_line() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints it."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return res.stdout.strip().splitlines()[0]
