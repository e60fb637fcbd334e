"""The plain reference of the benchmark: SPEEDY (T30/T63, 8 sigma levels,
full column physics, slab land and sea, SPPT) in plain PyTorch.

A frozen copy of the plain path of the PyTorch port (its CPU path), taken
when the benchmark was defined, with every kernel route taken out: the
transforms are the einsum chain, the grid dynamics, the column physics and
the spectral update their plain PyTorch versions, on any device. It imports
nothing of the port (``speedy_bench/tests`` holds it to that), so a later
change to the port's plain versions does not move the yardstick.
``runner`` holds what the benchmark calls: the model built and initialized
from the benchmark's inputs, and a run of steps from a state.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for `device`; raises if CUDA is asked for where
    there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but "
                           "torch.cuda.is_available() is False")
    return dev
