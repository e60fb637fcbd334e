"""pySPEEDY on PyTorch/CUDA: the port of ``pyspeedy_tpu`` to an NVIDIA GPU.

The package mirrors the JAX package's layout (``ops``, ``models``,
``coupling``, ``physics``, ``parallel``, ``utils``) so that each module's
counterpart is found under the same name. It imports ``torch`` and ``numpy``
(and ``scipy`` / ``h5py`` to read NetCDF) only. Ported: the member-batched
model with its column physics (``physics_on=True``, the default) or
without, SPPT, the ``Speedy`` / ``SpeedyEns`` API with the bundled boundary
conditions, and the ("ensemble", "space") mesh on ``torch.distributed``
(``parallel``); see the README's "PyTorch/CUDA port" section.
"""

from __future__ import annotations

from pathlib import Path

import torch

__all__ = ["resolve_device", "DEFAULT_OUTPUT_VARS", "example_bc_file",
           "example_sst_anomaly_file", "Speedy", "SpeedyEns", "ModelParams",
           "T30L8", "MODEL_STATE_DEF"]

PACKAGE_DATA_DIR = Path(__file__).resolve().parent / "data"
# The JAX package's data files, read by path (nothing of that package is
# imported).
JAX_PACKAGE_DATA_DIR = (Path(__file__).resolve().parent.parent
                        / "pyspeedy_tpu" / "data")

DEFAULT_OUTPUT_VARS = (
    "u_grid",
    "v_grid",
    "t_grid",
    "q_grid",
    "phi_grid",
    "ps_grid",
)


def example_bc_file():
    """Path to the bundled example boundary-conditions file: this package's
    NetCDF3 copy of the JAX package's NetCDF4 example_bc.nc (the same
    values; tests/test_torch_dataset.py writes it), which scipy reads
    without h5py."""
    return str(PACKAGE_DATA_DIR / "example_bc.nc")


def example_sst_anomaly_file():
    """Path to the bundled example SST anomaly file (the JAX package's,
    NetCDF3)."""
    return str(JAX_PACKAGE_DATA_DIR / "sst_anomaly.nc")


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for `device`; raises if CUDA is asked for where
    there is none (entry points default to the card and never fall back)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the host")
    return dev


from .params import ModelParams, T30L8  # noqa: E402
from .registry import MODEL_STATE_DEF  # noqa: E402
from .speedy import Speedy, SpeedyEns  # noqa: E402
