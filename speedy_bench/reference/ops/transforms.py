"""The einsum chain of the spectral transforms: the reference's one
transform route (a frozen copy of the port's einsum route)."""

from __future__ import annotations

import torch

__all__ = ["einsum_grid2spec", "einsum_spec2grid", "kcos_list"]


def einsum_grid2spec(sp, grid: torch.Tensor, pdim: int = 0) -> torch.Tensor:
    """The einsum chain of the direct transform: grid (..., il, ix) in the
    tables' type -> spectral pair with the pair axis at `pdim`, a DFT einsum
    against ``dft_fwd_ri`` and a Legendre einsum against
    ``cpol_dir_full``."""
    F2 = torch.einsum("...ji,cim->c...jm", grid, sp.dft_fwd_ri)
    S2 = torch.einsum("jmn,c...jm->c...mn", sp.cpol_dir_full, F2)
    return S2.movedim(0, pdim)


def einsum_spec2grid(sp, p: torch.Tensor, kcos: int = 1,
                     pdim: int = 0) -> torch.Tensor:
    """The einsum chain of the inverse transform: spectral pair (pair axis
    at `pdim`) -> grid (..., il, ix), scaled by 1/cos(lat) unless
    kcos == 1. ``dft_inv_ri[1, 0] == 0`` drops the imaginary part of m = 0."""
    F2 = torch.einsum("jmn,c...mn->c...jm", sp.cpol_inv_full,
                      p.movedim(pdim, 0))
    g = torch.einsum("c...jm,cmi->...ji", F2, sp.dft_inv_ri)
    if kcos != 1:
        g = g * sp.cosgr[:, None]
    return g


def kcos_list(kcos, n) -> list:
    """`kcos` (one value, or one per field) as a list of n values."""
    if isinstance(kcos, int):
        return [kcos] * n
    kcos = list(kcos)
    if len(kcos) != n:
        raise ValueError(f"{len(kcos)} kcos values for {n} fields")
    return kcos
