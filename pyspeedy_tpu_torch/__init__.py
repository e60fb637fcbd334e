"""pySPEEDY on PyTorch/CUDA: the port of ``pyspeedy_tpu`` to an NVIDIA GPU.

The package mirrors the JAX package's layout (``ops``, ``models``,
``coupling``, ``physics``, ``parallel``, ``utils``) so that each module's
counterpart is found under the same name. It imports ``torch`` and ``numpy``
only. Ported so far: the member-batched model with its column physics
(``physics_on=True``, the default) or without; see the README's "PyTorch/CUDA
port" section for what waits.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for `device`; raises if CUDA is asked for where
    there is none (entry points default to the card and never fall back)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the host")
    return dev
