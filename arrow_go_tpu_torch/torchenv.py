"""Device choice for the PyTorch/CUDA port (the part jaxenv.py plays in
the JAX package).

Entry points that create tensors resolve their device here: the card
unless the caller names one. A machine without a CUDA card is an error,
never a quiet move to the CPU; the CPU runs only when asked for
(`device="cpu"`, as the tests do).

A kernel wrapper picks its path from the tensor it is given: the
hand-written CUDA kernel for a CUDA tensor, the plain PyTorch version
for a CPU tensor. There is no switch that overrides this.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def device(dev: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `dev` when given, else the card."""
    if dev is not None:
        return torch.device(dev)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return torch.device("cuda")


def use_kernels(t: torch.Tensor) -> bool:
    """True when `t` lies on the card, so its kernels launch."""
    return t.is_cuda


__all__ = ["device", "use_kernels"]
