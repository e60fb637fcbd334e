"""The ("ensemble", "space") device mesh and the layout of a state on it.

Counterpart of the JAX package's ``parallel/mesh.py``. There a jitted step
declares shardings and XLA's partitioner places the collectives; an eager
port has no partitioner, so the layout here is the explicit pencil design of
the JAX package's ``parallel/shard_transforms.py``, one process per rank
(``torch.distributed``):

* the member axis of the carried fields is split over "ensemble" (members
  never communicate);
* grid fields (..., il, ix) lie in contiguous latitude bands over "space":
  the physics and the grid dynamics are column-local and need no halo;
* spectral fields are replicated over "space": a direct transform sums the
  bands' partial Legendre sums with one all_reduce, an inverse transform
  synthesises the band's rows from the replicated coefficients.

A layout is given per array as a ``Placement``: the axis that "ensemble"
splits and the axis that "space" splits, each None where the array is
replicated over that dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models import model as M
from ..registry import MODEL_STATE_VARS

__all__ = ["AXES", "Placement", "make_mesh", "mesh_shape", "mesh_coordinate",
           "space_band", "ensemble_state_sharding", "local_shard",
           "gather_state", "replicas_agree", "spectral_names"]

AXES = ("ensemble", "space")


class Placement(NamedTuple):
    """The axes of one array that the mesh's dimensions split (None:
    replicated over that dimension)."""

    ensemble: int | None
    space: int | None


def make_mesh(n_ensemble: int | None = None, n_space: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """An ("ensemble", "space") DeviceMesh over the ranks of the initialized
    default process group (parallel/distributed.py::initialize_distributed),
    rank r at (r // n_space, r % n_space): "space" varies fastest. Its two
    sub-groups are made with the default group's backend. Raises when
    n_ensemble * n_space is not the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "call parallel.distributed.initialize_distributed")
    world = dist.get_world_size()
    if n_ensemble is None:
        n_ensemble = world // n_space
    if n_ensemble * n_space != world or n_space < 1:
        raise ValueError(
            f"mesh {n_ensemble}x{n_space} != world size {world}")
    ranks = torch.arange(world).reshape(n_ensemble, n_space)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def mesh_shape(mesh) -> dict:
    """{"ensemble": n, "space": n}, as a JAX mesh's .shape."""
    return dict(zip(AXES, mesh.mesh.shape))


def mesh_coordinate(mesh) -> tuple:
    """(ensemble row, space index) of this rank."""
    e, s = mesh.get_coordinate()
    return int(e), int(s)


def space_band(mesh) -> tuple:
    """(n_space, this rank's band, the "space" process group)."""
    return (mesh_shape(mesh)["space"], mesh_coordinate(mesh)[1],
            mesh.get_group("space"))


def spectral_names() -> frozenset:
    """State fields that are spectral real pairs (2, ..., mx, nx): registry
    kind "c" and the spectral extras made at run time. They are not told
    apart by shape (at T47 and T63 mx and nx pass the grid test)."""
    return frozenset({s.name for s in MODEL_STATE_VARS if s.kind == "c"}
                     | {"sppt_spec", "tcorh", "qcorh"})


def _placement(name: str, a: torch.Tensor, batched: bool, n_space: int,
               shard_space: bool, spectral, piece: bool = False) -> Placement:
    """`piece`: `a` is a rank's piece, holding 1/n_space of the latitudes of
    a grid field that "space" splits."""
    lead = 0 if batched else None
    body = a.dim() - (1 if batched else 0)
    split = shard_space and n_space > 1
    if name in spectral or body < 2 or a.shape[-1] < 32:
        return Placement(lead, None)
    if a.shape[-2] * (n_space if piece and split else 1) < 32:
        return Placement(lead, None)
    # A grid field (..., il, ix): latitude bands over "space".
    if not split:
        return Placement(lead, None)
    if not piece and a.shape[-2] % n_space != 0:
        raise ValueError(
            f"{name}: {a.shape[-2]} latitudes do not split into {n_space} "
            f"bands")
    return Placement(lead, a.dim() - 2)


def _leaves(fn, val):
    return tuple(fn(a) for a in val) if isinstance(val, tuple) else fn(val)


def ensemble_state_sharding(mesh, state: dict, shard_space: bool = True,
                            eph_batched: bool = False) -> dict:
    """The Placement of every array of a member-batched state (a tuple of
    them for a leapfrog field): "ensemble" splits the member axis of the
    carried fields (DYNAMIC_FIELDS - EPHEMERAL_FIELDS; the ephemerals too
    with `eph_batched`, the layout of a physics-on run's output) and the
    SPPT keys; "space" splits the latitude axis of the grid fields when
    `shard_space`. Static fields are replicated over "ensemble".

    Differs from the JAX function on purpose in two places. Spectral fields
    are replicated over "space", where the jitted path splits n: the band
    design sums partial Legendre sums with one all_reduce and then needs the
    whole spectrum on every band for the step's spectral side and the next
    synthesis. And a grid whose latitudes do not split into n_space bands
    raises, where the JAX function replicates it: a band step cannot run on
    a replicated grid."""
    n_space = mesh_shape(mesh)["space"]
    spectral = spectral_names()
    out = {}
    for name, val in state.items():
        if name == "sppt_key":
            out[name] = Placement(0, None)
            continue
        batched = name in M.DYNAMIC_FIELDS and (
            eph_batched or name not in M.EPHEMERAL_FIELDS)
        out[name] = _leaves(
            lambda a: _placement(name, a, batched, n_space, shard_space,
                                 spectral), val)
    return out


def _is_batched(name: str, a: torch.Tensor) -> bool:
    """Whether a state array carries a member axis, from its rank."""
    if name == "sppt_key":
        return a.dim() == 2
    return name in M.DYNAMIC_FIELDS and a.dim() > M.single_member_ndim(name)


def _layout(mesh, state: dict, shard_space: bool, piece: bool) -> dict:
    """Placements of a state (a rank's piece of one with `piece`) whose
    member axes are read off the arrays."""
    n_space = mesh_shape(mesh)["space"]
    spectral = spectral_names()
    return {name: _leaves(lambda a: _placement(
        name, a, _is_batched(name, a), n_space, shard_space, spectral,
        piece), val) for name, val in state.items()}


def local_shard(mesh, state: dict, shard_space: bool = True,
                members_are_local: bool = False) -> dict:
    """This rank's piece of a member-batched state that every rank holds
    whole: its ensemble row's members (unless `members_are_local`: the
    member axes already hold this rank's members) and, with `shard_space`,
    its latitude band of every grid field. Pieces are views where they can
    be: an expanded member axis stays expanded; any other piece that is not
    contiguous is copied."""
    shape = mesh_shape(mesh)
    e, s = mesh_coordinate(mesh)
    layout = _layout(mesh, state, shard_space, piece=False)

    def cut(a, place):
        if place.ensemble is not None and not members_are_local:
            n = a.shape[place.ensemble]
            if n % shape["ensemble"] != 0:
                raise ValueError(f"{n} members do not split over "
                                 f"{shape['ensemble']} ensemble rows")
            a = a.chunk(shape["ensemble"], dim=place.ensemble)[e]
        if place.space is not None:
            a = a.chunk(shape["space"], dim=place.space)[s]
            if not a.is_contiguous() and 0 not in a.stride():
                a = a.contiguous()
        return a

    out = {}
    for name, val in state.items():
        place = layout[name]
        out[name] = (tuple(cut(a, p) for a, p in zip(val, place))
                     if isinstance(val, tuple) else cut(val, place))
    return out


def _all_gather(a: torch.Tensor, axis: int, group, n: int) -> torch.Tensor:
    if n == 1:
        return a
    as_bool = a.dtype == torch.bool
    src = (a.to(torch.uint8) if as_bool else a).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=axis)
    return out.bool() if as_bool else out


def gather_state(mesh, local: dict, shard_space: bool = True,
                 names=None) -> dict:
    """The whole member-batched state on every rank, from each rank's piece
    (local_shard's layout, member axes read off the arrays): one all_gather
    over "space" and one over "ensemble" per array that they split. For
    checks and output; `names` limits it to those fields."""
    shape = mesh_shape(mesh)
    if names is not None:
        local = {k: v for k, v in local.items() if k in names}
    layout = _layout(mesh, local, shard_space, piece=True)
    groups = {d: mesh.get_group(d) for d in AXES}

    def whole(a, place):
        if place.space is not None:
            a = _all_gather(a, place.space, groups["space"], shape["space"])
        if place.ensemble is not None:
            a = _all_gather(a, place.ensemble, groups["ensemble"],
                            shape["ensemble"])
        return a

    return {name: (tuple(whole(a, p) for a, p in zip(val, layout[name]))
                   if isinstance(val, tuple) else whole(val, layout[name]))
            for name, val in local.items()}


def replicas_agree(mesh, local: dict, names) -> bool:
    """Whether the named fields, replicated over "space" (the spectral
    state), hold the same bits on every band of this rank's row: the band
    design rests on it (every band steps the whole spectrum). One
    all_gather over "space"."""
    n = mesh_shape(mesh)["space"]
    flat = torch.cat([a.reshape(-1) for name in names for a in
                      (local[name] if isinstance(local[name], tuple)
                       else (local[name],))])
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=mesh.get_group("space"))
    return all(torch.equal(parts[0], p) for p in parts[1:])
