"""Latitude-band spectral transforms with hand-placed collectives.

Counterpart of the JAX package's ``parallel/shard_transforms.py``, whose
explicit pencil design this follows, on ``torch.distributed``:

* grid fields lie in contiguous latitude bands over the mesh's "space"
  dimension, one band per rank;
* the direct transform takes each field of a group through the zonal DFT and
  a partial Legendre sum over the band's rows (``cpol_dir_full``'s rows:
  the hemispheric fold and the Gaussian weights are baked into the
  full-sphere operator, so a band never needs its mirror rows), and sums
  the bands' partial sums with ONE ``all_reduce`` over "space" for the whole
  group;
* the inverse transform makes no communication: the coefficients are
  replicated and each band synthesises its own rows (``cpol_inv_full``'s
  rows, the 1/cos scale from the band's ``cosgr``).

The products are those of the fft or the einsum route of ``ops/spectral.py``
on the band's tables; the JAX package computes them with einsums outside any
Pallas kernel too. A band transform is a ``SpectralTransform`` whose ``band``
is a ``LatitudeBand``: it is never on the dense route (the fused kernels are
built for the whole T30 sphere), and ``ops.spectral.grid2spec_many_p`` /
``spec2grid_many_p`` route it here.

``counts`` counts the band transforms apart from every other route: calls and
fields of each direction, all_reduce calls and the bytes they reduced.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from ..ops import spectral as S
from ..ops import transform_kernels as TK
from .mesh import space_band

__all__ = ["LatitudeBand", "band_transform", "grid2spec_many_p",
           "spec2grid_many_p", "grid2spec_sharded", "spec2grid_sharded",
           "counts", "reset_counts"]

counts = {"direct_calls": 0, "direct_fields": 0, "inverse_calls": 0,
          "inverse_fields": 0, "all_reduce": 0, "all_reduce_bytes": 0}


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


class LatitudeBand(NamedTuple):
    """Band `index` of `n_space` equal latitude bands of an il-row grid, and
    the "space" process group whose ranks hold the bands (None for a band
    whose transforms are never called: they raise)."""

    n_space: int
    index: int
    il: int            # latitudes of the whole sphere
    group: Any = None

    @property
    def rows(self) -> slice:
        size = self.il // self.n_space
        return slice(self.index * size, (self.index + 1) * size)

    def grid2spec_many_p(self, sp, grids, pdim: int = 0) -> list:
        return grid2spec_many_p(sp, grids, pdim)

    def spec2grid_many_p(self, sp, pairs, kcos=1, pdim: int = 0) -> list:
        return spec2grid_many_p(sp, pairs, kcos, pdim)


def band_transform(sp, n_space: int, index: int, group=None):
    """The transform of latitude band `index` of `n_space`: sp with its
    band's rows of cpol_inv_full, cpol_dir_full, cosgr and cosgr2, off the
    dense route (the dense tables and the fused kernels' folded tables
    become placeholders), and the band set."""
    if sp.band is not None:
        raise ValueError("band_transform takes the whole sphere's transform")
    if n_space < 1 or sp.il % n_space != 0 or not 0 <= index < n_space:
        raise ValueError(f"band {index} of {n_space}: {sp.il} latitudes do "
                         f"not split so")
    band = LatitudeBand(n_space, index, sp.il, group)
    rows = band.rows
    cut = lambda t: t[rows].contiguous()
    mat = sp.cpol_dir_full.new_zeros((1, 1))
    vec = sp.cpol_dir_full.new_zeros((1,))
    return sp._replace(
        cosgr=cut(sp.cosgr), cosgr2=cut(sp.cosgr2),
        cpol_inv_full=cut(sp.cpol_inv_full),
        cpol_dir_full=cut(sp.cpol_dir_full),
        leg_dir_dense=mat, leg_inv_dense=mat,
        fold_dir=vec, fold_dir_bf16=vec, fold_inv=vec,
        use_dense_legendre=False, band=band)


def grid2spec_many_p(sp, grids, pdim: int = 0) -> list:
    """Direct transforms of a group of band fields (..., il/n_space, ix) on
    band transform `sp`: each field's partial Legendre sum over the band's
    rows, then ONE all_reduce (sum) over the "space" group for the whole
    group. Returns the spectral pairs, the pair axis at `pdim`, replicated
    on every band (contiguous)."""
    band = sp.band
    if band.group is None:
        raise RuntimeError("this band transform has no process group")
    grids = list(grids)
    parts = [S._grid2spec_routes(sp, g, pdim) for g in grids]
    if not parts:
        return []
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=band.group)
    counts["direct_calls"] += 1
    counts["direct_fields"] += len(parts)
    counts["all_reduce"] += 1
    counts["all_reduce_bytes"] += flat.numel() * flat.element_size()
    return [x.view(p.shape) for x, p in
            zip(flat.split([p.numel() for p in parts]), parts)]


def spec2grid_many_p(sp, pairs, kcos=1, pdim: int = 0) -> list:
    """Inverse transforms of a group of replicated spectral pairs to the
    band's rows on band transform `sp` (kcos one value or one per field):
    no communication."""
    pairs = list(pairs)
    kcos = TK.kcos_list(kcos, len(pairs))
    counts["inverse_calls"] += 1
    counts["inverse_fields"] += len(pairs)
    return [S._spec2grid_routes(sp, p, k, pdim) for p, k in zip(pairs, kcos)]


def _band_of(sp, mesh):
    n_space, index, group = space_band(mesh)
    return band_transform(sp, n_space, index, group)


def grid2spec_sharded(sp, mesh, grid: torch.Tensor) -> torch.Tensor:
    """Direct transform of this rank's latitude band of a grid batch:
    grid (B, il/n_space, ix), sp the whole sphere's transform. Returns the
    complex spectral (B, mx, nx), the same on every band; one all_reduce
    over "space"."""
    return S.unpair(grid2spec_many_p(_band_of(sp, mesh), [grid])[0])


def spec2grid_sharded(sp, mesh, spec: torch.Tensor,
                      kcos: int = 1) -> torch.Tensor:
    """Inverse transform of a replicated complex spectral (B, mx, nx) to this
    rank's latitude band (B, il/n_space, ix), scaled by 1/cos(lat) for
    kcos != 1; no communication."""
    return spec2grid_many_p(_band_of(sp, mesh), [S.pair(spec)], kcos)[0]
