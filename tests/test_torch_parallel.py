"""The port's multi-device layer on the CPU: four gloo processes, spawned once
for the file, hold the ("ensemble", "space") meshes 2x2, 1x4 and 4x1 of
``pyspeedy_tpu_torch.parallel`` and run the band transforms, the full T30
model and its physics-off and SPPT variants sharded; this process holds
their gathered results against the port's unsharded batched runner and
against the JAX package (its shard_map transforms on the 8-virtual-device
mesh, its batched runner, its sharding specs). Counterpart of
tests/test_parallel.py. Inputs are made with numpy from seeds.

Tolerances are absolute, as in tests/test_parallel.py: a band transform sums
the Legendre series band by band and then over the bands (the all_reduce),
so a sharded run differs from the unsharded one in the order of sums only.
Ensemble-only sharding changes only the batch width, which may change the
order of sums of a library matrix product on the CPU: 1e-12.

JAX is imported inside the tests: the spawned processes import this module
and must not start JAX.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from pyspeedy_tpu_torch import interop
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.ops import spectral as TS
from pyspeedy_tpu_torch.ops.geometry import build_geometry
from pyspeedy_tpu_torch.parallel import distributed as TD
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.parallel import mesh as TMESH
from pyspeedy_tpu_torch.parallel import shard_transforms as ST
from pyspeedy_tpu_torch.parallel.launch_multihost import (free_port,
                                                          run_workers)
from pyspeedy_tpu_torch.params import T30L8
from pyspeedy_tpu_torch.testing import make_demo_model

torch.set_num_threads(1)

PARAMS = dataclasses.replace(T30L8, fft_mode="matmul")
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
N_STEPS = 8
N_MEMBERS = 4
FIELDS = ("vor", "div", "t", "ps", "tr", "tt_rsw", "land_temp")
GATHERED = FIELDS + ("precnv", "error_flag", "hfluxn")
SPPT_FIELDS = ("vor", "div", "t", "ps", "tr", "sppt_spec", "sppt_key",
               "error_flag")


def transform_input():
    return np.random.default_rng(5).standard_normal((6, 48, 96))


def perturbation(nmem, seed=7):
    """Seeded noise for the temperature of each member, 0.01 K in spectral
    amplitude inside the truncation triangle; member 0 unperturbed."""
    p = PARAMS
    rng = np.random.default_rng(seed)
    m = np.arange(p.mx)[:, None]
    n = np.arange(p.nx)[None, :]
    tri = (m + n <= p.trunc).astype(float)
    noise = 1e-2 * rng.standard_normal((nmem, 2, p.kx, p.mx, p.nx)) * tri
    noise[0] = 0.0
    noise[:, 1, :, 0, :] = 0.0
    return noise


def perturbed(state, nmem):
    batched = TE.broadcast_state(state, nmem)
    noise = torch.from_numpy(perturbation(nmem))
    batched["t"] = tuple(lev + noise for lev in batched["t"])
    return batched


def to_numpy(state):
    return interop.state_to_numpy(state)


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _worker(rank, world, init, out_dir):
    """One rank: every sharded computation of the file; saves its results."""
    torch.set_num_threads(1)
    TD.initialize_distributed(init, world, rank, "gloo", "cpu")
    meshes = {k: TMESH.make_mesh(e, s, "cpu") for k, (e, s) in MESHES.items()}
    res = {"backends": {k: {d: torch.distributed.get_backend(m.get_group(d))
                            for d in TMESH.AXES} for k, m in meshes.items()},
           "coordinate": {k: TMESH.mesh_coordinate(m)
                          for k, m in meshes.items()}}

    # (a) and (b): the band transforms, one field batch and a group.
    sp = TS.build_spectral(PARAMS, build_geometry(PARAMS),
                           use_matmul_fft=True, device="cpu")
    g = torch.from_numpy(transform_input())
    for name in ("2x2", "1x4"):
        mesh = meshes[name]
        bsp = ST.band_transform(sp, *TMESH.space_band(mesh))
        rows = bsp.band.rows
        c0 = dict(ST.counts)
        spec = ST.grid2spec_sharded(sp, mesh, g[:, rows])
        c1 = dict(ST.counts)
        back = ST.spec2grid_sharded(sp, mesh, spec, 2)
        c2 = dict(ST.counts)
        pairs = TS.grid2spec_many_p(bsp, [g[:2, rows], g[2:4, rows],
                                          g[4:, rows]])
        c3 = dict(ST.counts)
        grids = TS.spec2grid_many_p(bsp, pairs, [1, 2, 1])
        c4 = dict(ST.counts)
        whole = lambda x: TMESH.gather_state(mesh, {"x": x})["x"].numpy()
        res[f"transforms_{name}"] = {
            "spec": spec.numpy(), "back": whole(back),
            "pairs": [p.numpy() for p in pairs],
            "grids": [whole(x) for x in grids],
            "direct": _delta(c1, c0), "inverse": _delta(c2, c1),
            "direct_group": _delta(c3, c2), "inverse_group": _delta(c4, c3)}

    # (c), (f), (g): the full model, sharded on each mesh.
    consts, state, cal = make_demo_model(PARAMS, device="cpu")
    batched = perturbed(state, N_MEMBERS)
    res["placements_in"] = TMESH.ensemble_state_sharding(meshes["2x2"],
                                                         batched)
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, N_STEPS)
    for name, mesh in meshes.items():
        local = TE.shard_ensemble(mesh, batched)
        ST.reset_counts()
        out = TE.make_run_steps_batched(consts, device="cpu", mesh=mesh)(
            local, ctx)
        res[f"counts_{name}"] = dict(ST.counts)
        res[f"bands_agree_{name}"] = TMESH.replicas_agree(
            mesh, out, ("vor", "div", "t", "ps", "tr"))
        res[f"shapes_{name}"] = {k: tuple(out[k][0].shape)
                                 if isinstance(out[k], tuple)
                                 else tuple(out[k].shape) for k in GATHERED}
        res[f"run_{name}"] = to_numpy(
            TMESH.gather_state(mesh, out, names=GATHERED))
        if name == "2x2":
            res["placements_out"] = TMESH.ensemble_state_sharding(
                mesh, TMESH.gather_state(mesh, out), eph_batched=True)

    # shard_space=False: each rank of a row steps its members on the whole
    # grid (no band, no collective).
    mesh = meshes["2x2"]
    ST.reset_counts()
    out = TE.make_run_steps_batched(consts, device="cpu", mesh=mesh,
                                    shard_space=False)(
        TE.shard_ensemble(mesh, batched, shard_space=False), ctx)
    res["counts_whole_grid"] = dict(ST.counts)
    res["shape_whole_grid"] = tuple(out["land_temp"].shape)
    res["run_whole_grid"] = to_numpy(TMESH.gather_state(
        mesh, out, shard_space=False, names=GATHERED))

    # (d): physics off, the ephemerals pass through unbatched.
    consts_off = dataclasses.replace(consts, physics_on=False)
    out = TE.make_run_steps_batched(consts_off, device="cpu", mesh=mesh)(
        TE.shard_ensemble(mesh, batched), ctx)
    res["off_shapes"] = {"hfluxn": tuple(out["hfluxn"].shape)}
    res["run_off"] = to_numpy(TMESH.gather_state(mesh, out, names=GATHERED))

    # (e): SPPT, sharded; the global-ensemble constructor gives the same
    # piece as cutting the whole ensemble.
    consts_s, state_s, cal_s = make_demo_model(
        dataclasses.replace(PARAMS, sppt_on=True), device="cpu")
    local = TE.shard_ensemble(mesh, TE.broadcast_state(state_s, N_MEMBERS))
    made = TD.make_global_ensemble(state_s, N_MEMBERS, mesh)
    res["sppt_global_same"] = sorted(
        k for k in local if not all(
            torch.equal(a, b) for a, b in zip(
                *(v if isinstance(v, tuple) else (v,)
                  for v in (local[k], made[k])))))
    ctx_s, _ = TM.build_step_ctx(dataclasses.replace(cal_s), 2, N_STEPS)
    out = TE.make_run_steps_batched(consts_s, device="cpu", mesh=mesh)(
        local, ctx_s)
    res["run_sppt"] = to_numpy(TMESH.gather_state(mesh, out,
                                                  names=SPPT_FIELDS))
    res["sppt_in"] = to_numpy(TMESH.gather_state(
        mesh, local, names=("sppt_spec", "sppt_key")))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    torch.save(res, out_dir / f"rank{rank}.pt")


def _unsharded():
    """The port's unsharded batched runs from the same states."""
    consts, state, cal = make_demo_model(PARAMS, device="cpu")
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, N_STEPS)
    batched = perturbed(state, N_MEMBERS)
    ref = {"state": to_numpy(state),
           "on": to_numpy(TE.make_run_steps_batched(consts, device="cpu")(
               batched, ctx)),
           "off": to_numpy(TE.make_run_steps_batched(
               dataclasses.replace(consts, physics_on=False),
               device="cpu")(batched, ctx))}
    consts_s, state_s, cal_s = make_demo_model(
        dataclasses.replace(PARAMS, sppt_on=True), device="cpu")
    ctx_s, _ = TM.build_step_ctx(dataclasses.replace(cal_s), 2, N_STEPS)
    start = TE.broadcast_state(state_s, N_MEMBERS)
    ref["sppt"] = to_numpy(TE.make_run_steps_batched(consts_s, device="cpu")(
        start, ctx_s))
    ref["sppt_start"] = to_numpy(start)
    return ref


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(per-rank results of the four spawned ranks, the unsharded runs). The
    unsharded runs are made here while the ranks run."""
    out_dir = tmp_path_factory.mktemp("ranks")
    codes = []
    ranks = threading.Thread(target=lambda: codes.extend(run_workers(
        _worker, WORLD, (WORLD, f"tcp://127.0.0.1:{free_port()}", out_dir),
        timeout_s=600)))
    ranks.start()
    try:
        ref = _unsharded()
    finally:
        ranks.join()
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    res = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return res, ref


def _fields(got, want, names):
    for name in names:
        g, w = got[name], want[name]
        for a, b in (zip(g, w) if isinstance(w, tuple) else [(g, w)]):
            yield name, np.asarray(a), np.asarray(b)


def test_meshes_and_group_backends(sharded):
    res, _ = sharded
    for r, rank in enumerate(res):
        for name, (e, s) in MESHES.items():
            assert rank["coordinate"][name] == (r // s, r % s)
            assert rank["backends"][name] == {"ensemble": "gloo",
                                              "space": "gloo"}


@pytest.mark.parametrize("mesh,jax_mesh", [("2x2", (4, 2)), ("1x4", (2, 4))])
def test_band_transforms_match_jax_shard_map(sharded, mesh, jax_mesh):
    """(a) grid2spec_sharded / spec2grid_sharded (kcos=2) against the JAX
    package's shard_map transforms on the same (6, 48, 96) input, on the
    8-virtual-device mesh with the same number of bands."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pyspeedy_tpu.ops import spectral as JS
    from pyspeedy_tpu.ops.geometry import build_geometry as j_geometry
    from pyspeedy_tpu.params import T30L8 as J_T30L8
    from pyspeedy_tpu.parallel.mesh import make_mesh as j_make_mesh
    from pyspeedy_tpu.parallel.shard_transforms import (
        grid2spec_sharded, spec2grid_sharded)

    jp = dataclasses.replace(J_T30L8, fft_mode="matmul")
    jsp = JS.build_spectral(jp, j_geometry(jp), use_matmul_fft=True)
    jmesh = j_make_mesh(*jax_mesh)
    g = jax.device_put(jnp.asarray(transform_input()),
                       NamedSharding(jmesh, P(None, "space", None)))
    spec = grid2spec_sharded(jsp, jmesh, g)
    back = spec2grid_sharded(jsp, jmesh, spec, 2)
    res, _ = sharded
    for rank in res:
        got = rank[f"transforms_{mesh}"]
        np.testing.assert_allclose(got["spec"], np.asarray(spec), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got["back"], np.asarray(back), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_band_transform_groups_match_the_whole_sphere(sharded, mesh):
    """A group of three fields through the band route equals the whole
    sphere's transforms of the same fields (the port's dense route on the
    CPU, the plain matmul chain)."""
    sp = TS.build_spectral(PARAMS, build_geometry(PARAMS),
                           use_matmul_fft=True, device="cpu")
    g = torch.from_numpy(transform_input())
    fields = [g[:2], g[2:4], g[4:]]
    want = TS.grid2spec_many_p(sp, fields)
    back = TS.spec2grid_many_p(sp, want, [1, 2, 1])
    res, _ = sharded
    for rank in res:
        got = rank[f"transforms_{mesh}"]
        for a, b in zip(got["pairs"], want):
            np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-12)
        for a, b in zip(got["grids"], back):
            np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_collective_counts(sharded, mesh):
    """(b) a direct transform, one field batch or a group of three, makes
    exactly one all_reduce of the group's spectral bytes; an inverse makes
    none. A sharded run makes one all_reduce per direct group: one a step
    and one for each of the two fields of a daily forcing (none in these
    8 steps)."""
    res, _ = sharded
    pair_bytes = 2 * 6 * PARAMS.mx * PARAMS.nx * 8
    for rank in res:
        t = rank[f"transforms_{mesh}"]
        assert t["direct"] == {"direct_calls": 1, "direct_fields": 1,
                               "inverse_calls": 0, "inverse_fields": 0,
                               "all_reduce": 1,
                               "all_reduce_bytes": pair_bytes}
        assert t["inverse"] == {"direct_calls": 0, "direct_fields": 0,
                                "inverse_calls": 1, "inverse_fields": 1,
                                "all_reduce": 0, "all_reduce_bytes": 0}
        assert t["direct_group"]["all_reduce"] == 1
        assert t["direct_group"]["direct_fields"] == 3
        assert t["direct_group"]["all_reduce_bytes"] == pair_bytes
        assert t["inverse_group"]["all_reduce"] == 0
        assert t["inverse_group"]["inverse_fields"] == 3
        c = rank[f"counts_{mesh}"]
        assert c["all_reduce"] == c["direct_calls"] == N_STEPS
        # Two inverse groups a step: the dynamics' and the physics'.
        assert c["inverse_calls"] == 2 * N_STEPS
        assert c["direct_fields"] == N_STEPS * (7 + 3 * PARAMS.ntr)
    assert res[0]["counts_4x1"] == dict.fromkeys(ST.counts, 0)


@pytest.mark.parametrize("mesh,atol", [("2x2", 1e-10), ("1x4", 1e-10),
                                       ("4x1", 1e-12)])
def test_sharded_full_model_matches_unsharded(sharded, mesh, atol):
    """(c) the full T30 model, 8 steps of 4 perturbed members, on each mesh
    against the port's unsharded batched run."""
    res, ref = sharded
    got = res[0][f"run_{mesh}"]
    for name, a, b in _fields(got, ref["on"], FIELDS + ("precnv",)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)
    assert not got["error_flag"].any()
    # The bands of a row stepped the same spectral state, bitwise.
    assert all(rank[f"bands_agree_{mesh}"] for rank in res)
    # Each rank held its band of the grid fields and its members.
    e, s = MESHES[mesh]
    shapes = res[0][f"shapes_{mesh}"]
    assert shapes["land_temp"] == (N_MEMBERS // e, 48 // s, 96)
    assert shapes["t"][0] == N_MEMBERS // e
    t0 = got["t"][0]
    assert np.abs(t0[1] - t0[0]).max() > 1e-4


def test_ensemble_split_alone_on_a_2x2_mesh(sharded):
    """shard_space=False on a 2x2 mesh: the two ranks of a row step the
    row's members on the whole grid, with no band transform."""
    res, ref = sharded
    assert res[0]["counts_whole_grid"] == dict.fromkeys(ST.counts, 0)
    assert res[0]["shape_whole_grid"] == (N_MEMBERS // 2, 48, 96)
    for name, a, b in _fields(res[0]["run_whole_grid"], ref["on"], FIELDS):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=name)


def test_sharded_physics_off_ephemeral_layout(sharded):
    """(d) with the physics off the ephemerals pass through at the
    single-member layout (here each rank's band of it), and the run matches
    the unsharded one."""
    res, ref = sharded
    assert res[0]["off_shapes"]["hfluxn"] == (3, 24, 96)
    got = res[0]["run_off"]
    assert got["hfluxn"].shape == ref["state"]["hfluxn"].shape == (3, 48, 96)
    assert ref["off"]["hfluxn"].shape == (3, 48, 96)
    for name, a, b in _fields(got, ref["off"], ("vor", "div", "t", "ps",
                                                "hfluxn")):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10, err_msg=name)


def test_sharded_sppt_matches_unsharded(sharded):
    """(e) SPPT on a 2x2 mesh: every band of a member draws that member's
    noise, so the result equals the unsharded run; the members diverge and
    the AR(1) spectrum advanced; make_global_ensemble gives each rank the
    same piece as cutting the whole ensemble."""
    res, ref = sharded
    for rank in res:
        assert rank["sppt_global_same"] == []
    got = res[0]["run_sppt"]
    for name, a, b in _fields(got, ref["sppt"], ("vor", "div", "t", "ps",
                                                 "tr", "sppt_spec")):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10, err_msg=name)
    np.testing.assert_array_equal(got["sppt_key"], ref["sppt"]["sppt_key"])
    np.testing.assert_array_equal(res[0]["sppt_in"]["sppt_key"],
                                  ref["sppt_start"]["sppt_key"])
    assert not got["error_flag"].any()
    t0 = got["t"][0]
    for m in range(1, N_MEMBERS):
        assert np.abs(t0[m] - t0[0]).max() > 1e-3
    assert np.abs(got["sppt_spec"] - res[0]["sppt_in"]["sppt_spec"]).max() \
        > 1e-3


def test_sharded_model_matches_jax(sharded):
    """(f) the slice as a whole: the port's 2x2 sharded run against the JAX
    package's unsharded batched runner from the same initial state (the
    port's, carried over through numpy) and the same perturbation."""
    import jax
    import jax.numpy as jnp
    from pyspeedy_tpu.models import model as JM
    from pyspeedy_tpu.parallel import ensemble as JE
    from pyspeedy_tpu.params import T30L8 as J_T30L8
    from pyspeedy_tpu.utils.calendar import ModelCalendar as JCalendar
    from pyspeedy_tpu_torch.testing import DEMO_START

    res, ref = sharded
    jp = dataclasses.replace(J_T30L8, fft_mode="matmul")
    jconsts, _ = JM.build_consts(jp)
    jstate = jax.tree.map(jnp.asarray, ref["state"])
    jb = JE.broadcast_state(jstate, N_MEMBERS)
    noise = perturbation(N_MEMBERS)
    jb["t"] = tuple(lev + noise for lev in jb["t"])
    cal = JCalendar.from_datetime(DEMO_START, nsteps=jp.nsteps)
    ctx, _ = JM.build_step_ctx(cal, 2, N_STEPS)
    jout = jax.tree.map(np.asarray,
                        JE.make_run_steps_batched(jconsts)(jb, ctx))
    got = res[0]["run_2x2"]
    for name, a, b in _fields(got, jout, FIELDS):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10, err_msg=name)


def _axes(spec):
    """(ensemble axis, space axis) of a JAX PartitionSpec."""
    spec = tuple(spec)
    find = lambda d: spec.index(d) if d in spec else None
    return find("ensemble"), find("space")


@pytest.mark.parametrize("which", ["placements_in", "placements_out"])
def test_ensemble_state_sharding_matches_jax_specs(sharded, which):
    """(g) field by field against the JAX package's specs for the same
    shapes (a 4x2 mesh: 2 bands, as the port's 2x2): the same member axes
    and latitude axes; the spectral fields split over "space" by JAX (on n)
    are replicated in the port."""
    import jax
    from pyspeedy_tpu.parallel.mesh import (ensemble_state_sharding,
                                            make_mesh as j_make_mesh)

    res, ref = sharded
    placements = res[0][which]
    if which == "placements_in":
        state = to_numpy(perturbed(interop.state_from_numpy(
            ref["state"], device="cpu"), N_MEMBERS))
    else:
        state = ref["on"]
    shapes = {k: (tuple(np.broadcast_to(0.0, a.shape) for a in v)
                  if isinstance(v, tuple) else np.broadcast_to(0.0, v.shape))
              for k, v in state.items()}
    jspecs = ensemble_state_sharding(j_make_mesh(4, 2), shapes,
                                     eph_batched=which == "placements_out")
    spectral = TMESH.spectral_names()
    assert set(placements) == set(jspecs)
    n_space_split = 0
    for name, jsh in jspecs.items():
        port = placements[name]
        jleaves = jax.tree.leaves(jsh)
        pleaves = (port,) if isinstance(port, TMESH.Placement) else port
        assert len(jleaves) == len(pleaves), name
        for js, p in zip(jleaves, pleaves):
            e, s = _axes(js.spec)
            assert p.ensemble == e, (name, p, js.spec)
            if name in spectral:
                assert p.space is None, name
            else:
                assert p.space == s, (name, p, js.spec)
                n_space_split += s is not None
    assert n_space_split > 40


def test_band_consts_hold_the_band_rows_of_every_latitude_table():
    """models.model.band_consts: each per-latitude table is the band's rows
    of the sphere's, the band transform is off the dense route (the fused
    kernels serve the whole T30 sphere alone), and the grid-dynamics
    function on a band's fields equals the sphere's on those rows."""
    consts, _ = TM.build_consts(PARAMS, device="cpu")
    assert consts.sp.use_dense_legendre
    for index in range(4):
        band = TM.band_consts(consts, 4, index)
        rows = slice(12 * index, 12 * (index + 1))
        assert band.sp.il == 12 and band.sp.band.rows == rows
        assert not band.sp.use_dense_legendre
        for name in ("cpol_inv_full", "cpol_dir_full", "cosgr", "cosgr2"):
            assert torch.equal(getattr(band.sp, name),
                               getattr(consts.sp, name)[rows]), name
        for name in ("radang", "coriol", "sia", "coa", "cosg", "cosgr",
                     "cosgr2"):
            np.testing.assert_array_equal(getattr(band.geom, name),
                                          getattr(consts.geom, name)[rows])
        assert torch.equal(band.col.rcos, consts.col.rcos[rows])
        assert torch.equal(band.col.coriol, consts.col.coriol[rows])
        assert torch.equal(band.phys.sqrtcoa, consts.phys.sqrtcoa[rows])
        # Spectral and level tables are the sphere's.
        assert band.sp.el2 is consts.sp.el2 and band.hd is consts.hd
    from pyspeedy_tpu_torch.models.tendencies import grid_dynamics_core
    rng = np.random.default_rng(11)
    kx, ntr = PARAMS.kx, PARAMS.ntr
    mk = lambda k, s: torch.from_numpy(s * rng.standard_normal((2, k, 48, 96)))
    args = (mk(kx, 3e-5), mk(kx, 1e-5), 250 + mk(kx, 15.0),
            mk(ntr * kx, 2.0), mk(kx, 15.0), mk(kx, 10.0), mk(2, 2e-8))
    whole = grid_dynamics_core(consts.col, *args)
    band = TM.band_consts(consts, 2, 1)
    part = grid_dynamics_core(band.col, *(a[:, :, 24:] for a in args))
    for w, p in zip(whole, part):
        assert torch.equal(w[..., 24:, :], p)


def test_band_transforms_refuse_what_they_cannot_take():
    sp = TS.build_spectral(PARAMS, build_geometry(PARAMS),
                           use_matmul_fft=True, device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        ST.band_transform(sp, 5, 0)
    with pytest.raises(ValueError, match="do not split"):
        ST.band_transform(sp, 2, 2)
    band = ST.band_transform(sp, 2, 0)
    with pytest.raises(ValueError, match="whole sphere"):
        ST.band_transform(band, 2, 0)
    # Without a process group the band's direct transform raises (such
    # Consts serve the column kernels); its inverse needs none.
    g = torch.zeros((3, 24, 96), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="no process group"):
        TS.grid2spec_many_p(band, [g])
    pair = torch.zeros((2, 3, PARAMS.mx, PARAMS.nx), dtype=torch.float64)
    assert TS.spec2grid_p(band, pair, 2).shape == (3, 24, 96)


def test_initialize_distributed_refuses_nccl_without_one_card_a_rank():
    """nccl is refused before any process group is made: on the CPU, and for
    more ranks on a node than cards (here: none)."""
    with pytest.raises(ValueError, match="backend must be one of"):
        TD.initialize_distributed("tcp://127.0.0.1:1", 2, 0, "mpi", "cpu")
    with pytest.raises(ValueError, match="use gloo on the CPU"):
        TD.initialize_distributed("tcp://127.0.0.1:1", 2, 0, "nccl", "cpu")
    assert not torch.distributed.is_initialized()


def test_ensemble_state_sharding_raises_where_bands_do_not_split():
    """A band step cannot run on a replicated grid: 48 latitudes over 5
    bands raise (the JAX function would replicate them)."""
    import types

    _, state, _ = make_demo_model(PARAMS, device="cpu")
    batched = TE.broadcast_state(state, 2)
    five = types.SimpleNamespace(mesh=torch.empty(1, 5))
    with pytest.raises(ValueError, match="do not split into 5 bands"):
        TMESH.ensemble_state_sharding(five, batched)
    place = TMESH.ensemble_state_sharding(five, batched, shard_space=False)
    assert place["land_temp"] == TMESH.Placement(0, None)
    assert place["vor"] == (TMESH.Placement(0, None),) * 2
