"""Multi-process execution: process-group initialization, node-aware meshes
and the construction of a sharded ensemble.

Counterpart of the JAX package's ``parallel/distributed.py``, on
``torch.distributed`` with one process per rank (PyTorch's SPMD idiom). The
scale-out design is the JAX package's: members ("ensemble") never
communicate, so that dimension may span nodes; the transforms' one
all_reduce a direct group runs over "space", which stays inside a node.

Typical entry, one process per rank (torchrun sets the variables):

    from pyspeedy_tpu_torch.parallel import distributed as D
    D.initialize_distributed(backend="nccl")   # one card per rank
    mesh = D.make_hybrid_mesh(n_space=2)
    state = D.make_global_ensemble(state, n_members, mesh)
    run = make_run_steps_batched(consts, mesh=mesh)

``python -m pyspeedy_tpu_torch.parallel.launch_multihost`` drives this path
with N local processes.

The backend is the caller's: "nccl" for one rank per card, "gloo" for the
CPU and for ranks that share a card (gloo reduces and gathers CUDA tensors
through the host). "nccl" with two local ranks on one card raises before the
process group is made; nothing switches backend on its own.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .. import resolve_device
from ..models import model as M
from ..physics import sppt as SP
from .mesh import local_shard, make_mesh, mesh_coordinate, mesh_shape

__all__ = ["initialize_distributed", "rank_device", "local_world_size",
           "make_hybrid_mesh", "check_space_fits_node",
           "process_local_members", "member_range", "make_global_ensemble",
           "BACKENDS"]

BACKENDS = ("gloo", "nccl")
_DEVICE = {"device": None, "local_world_size": 1}


def _env_int(name: str):
    return int(os.environ[name]) if name in os.environ else None


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None,
                           device="cuda") -> bool:
    """Make the default process group (idempotent) and pick this rank's
    device. Returns True when more than one rank takes part.

    Arguments default from torchrun's variables: RANK, WORLD_SIZE,
    MASTER_ADDR/MASTER_PORT (init_method "env://"), LOCAL_RANK and
    LOCAL_WORLD_SIZE (default: the rank and the world size, one node). With
    neither an init_method nor MASTER_ADDR and a world of one, nothing is
    initialized (returns False), as the JAX function does for one process.

    backend: "nccl" or "gloo", named by the caller when a group is made.
    device: "cuda" (the default) gives rank r the card
    cuda:{LOCAL_RANK % device_count}, made current; "cpu" keeps the rank on
    the host. A rank asked for CUDA runs on CUDA or raises."""
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    world = world_size or 1
    local_rank = _env_int("LOCAL_RANK")
    local_rank = (rank or 0) if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or world

    if dist.is_initialized():
        if _DEVICE["device"] is None:
            _DEVICE.update(device=_pick_device(device, local_rank, local_world,
                                               dist.get_backend()),
                           local_world_size=local_world)
        return dist.get_world_size() > 1
    if init_method is None and world == 1:
        _DEVICE.update(device=_pick_device(device, 0, 1, backend),
                       local_world_size=1)
        return False
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS} (nccl: one "
                         f"rank per card; gloo: the CPU, or ranks that "
                         f"share a card), got {backend!r}")
    if rank is None:
        raise ValueError("the rank is needed: pass rank= or set RANK")
    dev = _pick_device(device, local_rank, local_world, backend)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    _DEVICE.update(device=dev, local_world_size=local_world)
    return world > 1


def _pick_device(device, local_rank: int, local_world: int,
                 backend) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError("nccl reduces CUDA tensors: use gloo on the CPU")
        return dev
    n_cards = torch.cuda.device_count()
    if backend == "nccl" and local_world > n_cards:
        raise RuntimeError(
            f"nccl needs one card per rank: {local_world} ranks on this node "
            f"and {n_cards} card(s); ranks that share a card take gloo")
    dev = torch.device("cuda", local_rank % n_cards)
    torch.cuda.set_device(dev)
    return dev


def rank_device() -> torch.device:
    """This rank's device, as initialize_distributed picked it."""
    if _DEVICE["device"] is None:
        raise RuntimeError("call initialize_distributed first")
    return _DEVICE["device"]


def local_world_size() -> int:
    """Ranks on this node (LOCAL_WORLD_SIZE, or the world on one node)."""
    return _DEVICE["local_world_size"]


def make_hybrid_mesh(n_space: int = 1):
    """The ("ensemble", "space") mesh with "space" inside a node: rank r at
    (r // n_space, r % n_space), ranks numbered node by node as torchrun
    numbers them, so that every "space" group (and with it every transform
    all_reduce) stays on one node and only "ensemble" may cross nodes.
    Raises unless n_space divides the ranks of a node."""
    if not dist.is_initialized():
        raise RuntimeError("call initialize_distributed first")
    check_space_fits_node(n_space, dist.get_world_size(), local_world_size())
    return make_mesh(dist.get_world_size() // n_space, n_space,
                     device_type=rank_device().type)


def check_space_fits_node(n_space: int, world: int, local_world: int):
    """Raise unless n_space divides the ranks of a node (and so the world
    of whole nodes)."""
    if n_space < 1 or local_world % n_space != 0 or world % n_space != 0:
        raise ValueError(
            f"n_space={n_space} must divide the ranks of a node "
            f"({local_world}) so that the transforms' all_reduce stays "
            f"inside a node")


def member_range(n_members: int, n_ensemble: int, row: int) -> range:
    """Members of ensemble row `row` of `n_ensemble`, in equal blocks."""
    if n_members % n_ensemble != 0:
        raise ValueError(f"{n_members} members not divisible by "
                         f"ensemble={n_ensemble}")
    per = n_members // n_ensemble
    return range(row * per, (row + 1) * per)


def process_local_members(n_members: int, mesh) -> range:
    """Member ids this rank holds: those of its ensemble row (the same on
    every rank of a "space" group)."""
    return member_range(n_members, mesh_shape(mesh)["ensemble"],
                        mesh_coordinate(mesh)[0])


def make_global_ensemble(state: dict, n_members: int, mesh,
                         shard_space: bool = True) -> dict:
    """This rank's piece of an n_members ensemble of the single-member
    `state`, which every rank builds the same (the demo model's
    initialization, or a restart read on each rank): the carried fields
    with a member axis over its ensemble row's members (an expanded view),
    with shard_space its latitude band of every grid field, and with SPPT
    the keys of its global member ids i, fold_in(key, i), which is what
    broadcast_state gives member i of the whole ensemble. No rank moves
    another's data."""
    ids = process_local_members(n_members, mesh)
    key = state.get("sppt_key")
    batched = M.add_member_axis(
        {k: v for k, v in state.items() if k != "sppt_key"}, len(ids))
    if key is not None:
        batched["sppt_key"] = SP.fold_in(
            key, torch.arange(ids.start, ids.stop, device=key.device))
    return local_shard(mesh, batched, shard_space, members_are_local=True)
