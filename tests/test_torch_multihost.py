"""Multi-process execution of the port (counterpart of tests/test_multihost.py):
the launcher ``python -m pyspeedy_tpu_torch.parallel.launch_multihost`` with
two CPU processes over gloo, at one and two latitude bands; and, in four
spawned gloo processes that stand for two nodes of two ranks, the node-aware
mesh, each rank's members and the SPPT keys of a global ensemble against the
JAX package's process_local_members and make_global_ensemble. A gpu-marked
case holds the 4x1 sharded run on the card bitwise to the unsharded run.

JAX is imported inside the tests: the spawned processes import this module
and must not start JAX.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from pyspeedy_tpu_torch.parallel import distributed as TD
from pyspeedy_tpu_torch.parallel import mesh as TMESH
from pyspeedy_tpu_torch.parallel.launch_multihost import (
    MEMBERS_PER_ENSEMBLE_ROW, free_port, run_workers)
from pyspeedy_tpu_torch.physics import sppt as SP

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
LOCAL_WORLD = 2           # two "nodes" of two ranks
MESHES = {"4x1": (4, 1), "2x2": (2, 2), "1x4": (1, 4)}
N_MEMBERS = 8
SEED = 42


def _launch(n_space):
    r = subprocess.run(
        [sys.executable, "-m", "pyspeedy_tpu_torch.parallel.launch_multihost",
         "2", "--n-space", str(n_space), "--device", "cpu",
         "--backend", "gloo"],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    return r.returncode, lines, r.stderr


@pytest.mark.parametrize("n_space", [1, 2])
def test_two_processes_match_the_single_process_run(n_space):
    rc, lines, err = _launch(n_space)
    assert rc == 0, f"launcher failed:\n{err[-3000:]}"
    summary = lines[-1]
    assert summary["multihost_ok"] is True
    assert summary["exit_codes"] == [0, 0]
    workers = sorted((ln for ln in lines if "rank" in ln),
                     key=lambda ln: ln["rank"])
    assert [w["rank"] for w in workers] == [0, 1]
    mesh = {"ensemble": 2 // n_space, "space": n_space}
    for w in workers:
        assert w["ok"] is True and w["sppt_ok"] is True
        assert w["world"] == 2 and w["mesh"] == mesh
        assert w["backend"] == "gloo" and w["device"] == "cpu"
        assert w["group_backends"] == {"ensemble": "gloo", "space": "gloo"}
        assert w["max_rel_err_vs_single"] <= 1e-10
        assert w["sppt_member_spread"] > 1e-10
    per = MEMBERS_PER_ENSEMBLE_ROW
    assert [w["members"] for w in workers] == [
        [(r // n_space) * per, (r // n_space + 1) * per] for r in range(2)]


def test_space_must_fit_a_node():
    """make_hybrid_mesh's rule: n_space divides the ranks of a node."""
    TD.check_space_fits_node(2, world=4, local_world=2)
    TD.check_space_fits_node(1, world=4, local_world=2)
    for n_space in (3, 4, 0):
        with pytest.raises(ValueError, match="ranks of a node"):
            TD.check_space_fits_node(n_space, world=4, local_world=2)


def _worker(rank, world, init, out_dir):
    torch.set_num_threads(1)
    os.environ.update(LOCAL_RANK=str(rank % LOCAL_WORLD),
                      LOCAL_WORLD_SIZE=str(LOCAL_WORLD))
    TD.initialize_distributed(init, world, rank, "gloo", "cpu")
    res = {"local_world": TD.local_world_size()}
    try:
        TD.make_hybrid_mesh(4)
        res["hybrid_4"] = "made"
    except ValueError as e:
        res["hybrid_4"] = str(e)
    hybrid = TD.make_hybrid_mesh(2)
    res["hybrid_2"] = (TMESH.mesh_shape(hybrid),
                       TMESH.mesh_coordinate(hybrid))
    key = SP.key_data(SEED)
    state = {"sppt_key": key, "error_flag": torch.tensor(False)}
    for name, (e, s) in MESHES.items():
        mesh = TMESH.make_mesh(e, s, "cpu")
        ids = TD.process_local_members(N_MEMBERS, mesh)
        local = TD.make_global_ensemble(state, N_MEMBERS, mesh)
        res[name] = {"members": (ids.start, ids.stop),
                     "keys": local["sppt_key"].numpy(),
                     "flag_shape": tuple(local["error_flag"].shape)}
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    torch.save(res, out_dir / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("ranks")
    codes = run_workers(_worker, WORLD,
                        (WORLD, f"tcp://127.0.0.1:{free_port()}", out_dir),
                        timeout_s=300)
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_hybrid_mesh_keeps_space_inside_a_node(ranks):
    for r, res in enumerate(ranks):
        assert res["local_world"] == LOCAL_WORLD
        assert "ranks of a node" in res["hybrid_4"]
        shape, coord = res["hybrid_2"]
        assert shape == {"ensemble": 2, "space": 2}
        # The space group of rank r is {r, r ^ 1}: one node.
        assert coord == (r // 2, r % 2)


def _jax_process_local_members(n_members, e, s, process):
    """The JAX package's function for the process that holds ensemble row
    `process` whole (its make_hybrid_mesh keeps a space row in a process)."""
    import jax
    from pyspeedy_tpu.parallel import distributed as JD

    devices = np.array([[types.SimpleNamespace(process_index=i)
                         for _ in range(s)] for i in range(e)])
    mesh = types.SimpleNamespace(shape={"ensemble": e, "space": s},
                                 devices=devices)
    saved = jax.process_index
    jax.process_index = lambda: process
    try:
        return JD.process_local_members(n_members, mesh)
    finally:
        jax.process_index = saved


@pytest.mark.parametrize("mesh", list(MESHES))
def test_process_local_members_match_jax(ranks, mesh):
    """Every rank holds the members of its ensemble row: what the JAX
    function gives the process that holds that row."""
    e, s = MESHES[mesh]
    for r, res in enumerate(ranks):
        want = _jax_process_local_members(N_MEMBERS, e, s, r // s)
        assert res[mesh]["members"] == (want.start, want.stop)
        assert res[mesh]["flag_shape"] == (N_MEMBERS // e,)
    with pytest.raises(ValueError, match="divisible"):
        TD.member_range(7, 2, 0)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_global_ensemble_keys_match_jax(ranks, mesh):
    """The SPPT keys of each rank's members equal the key data of the JAX
    package's make_global_ensemble for the same base key."""
    import jax
    from pyspeedy_tpu.parallel import distributed as JD
    from pyspeedy_tpu.parallel.mesh import make_mesh as j_make_mesh

    state = {"sppt_key": np.asarray(jax.random.key_data(
        jax.random.key(SEED))), "error_flag": np.asarray(False)}
    want = np.asarray(JD.make_global_ensemble(
        state, N_MEMBERS, j_make_mesh(4, 2))["sppt_key"])
    for res in ranks:
        lo, hi = res[mesh]["members"]
        np.testing.assert_array_equal(res[mesh]["keys"].astype(np.uint32),
                                      want[lo:hi])


N_STEPS_GPU = 6
N_MEMBERS_GPU = 8


def _gpu_worker(rank, world, init, backend, out_dir):
    from pyspeedy_tpu_torch.models import model as TM
    from pyspeedy_tpu_torch.parallel.ensemble import make_run_steps_batched
    from pyspeedy_tpu_torch.params import T30L8
    from pyspeedy_tpu_torch.testing import make_demo_model

    TD.initialize_distributed(init, world, rank, backend, "cuda")
    mesh = TD.make_hybrid_mesh(1)
    consts, state, cal = make_demo_model(T30L8, device=TD.rank_device(),
                                         precision="f32", fft_mode="matmul")
    local = TD.make_global_ensemble(state, N_MEMBERS_GPU, mesh)
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, N_STEPS_GPU)
    out = make_run_steps_batched(consts, device=TD.rank_device(),
                                 mesh=mesh)(local, ctx)
    whole = TMESH.gather_state(mesh, out, names=("vor", "div", "t", "ps",
                                                 "tr", "land_temp"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    if rank == 0:
        torch.save({k: (tuple(a.cpu() for a in v) if isinstance(v, tuple)
                        else v.cpu()) for k, v in whole.items()},
                   out_dir / "whole.pt")


@pytest.mark.gpu
def test_ensemble_sharding_on_the_card_is_bitwise(tmp_path):
    """Needs an NVIDIA GPU and nvcc: four ranks on a 4x1 mesh (gloo on a
    shared card, nccl with a card each), 8 float32 members, 6 steps with
    the physics: gathered, bitwise the unsharded run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    from pyspeedy_tpu_torch.models import model as TM
    from pyspeedy_tpu_torch.ops.column_kernels import build_kernels
    from pyspeedy_tpu_torch.parallel.ensemble import (broadcast_state,
                                                       make_run_steps_batched)
    from pyspeedy_tpu_torch.params import T30L8
    from pyspeedy_tpu_torch.testing import make_demo_model

    build_kernels()
    backend = "nccl" if torch.cuda.device_count() >= WORLD else "gloo"
    codes = run_workers(_gpu_worker, WORLD,
                        (WORLD, f"tcp://127.0.0.1:{free_port()}", backend,
                         tmp_path), timeout_s=600)
    assert codes == [0] * WORLD
    consts, state, cal = make_demo_model(T30L8, device="cuda",
                                         precision="f32", fft_mode="matmul")
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, N_STEPS_GPU)
    ref = make_run_steps_batched(consts, device="cuda")(
        broadcast_state(state, N_MEMBERS_GPU), ctx)
    whole = torch.load(tmp_path / "whole.pt", weights_only=False)
    for name, got in whole.items():
        want = ref[name]
        for a, b in (zip(got, want) if isinstance(got, tuple)
                     else [(got, want)]):
            assert torch.equal(a, b.cpu()), name
