"""The port's precomputed tables against the JAX package's: geometry,
spectral operators, horizontal diffusion, implicit solver (three time steps),
geopotential and the longwave band table. Both are numpy float64 builders
rounded to the model dtype, so float64 tables must agree to 1e-14 of each
table's largest entry (most agree bitwise; the margin allows for a different
order in the host-side rounding of products)."""

import numpy as np
import pytest
import torch

import pyspeedy_tpu.params as jparams
import pyspeedy_tpu_torch.params as tparams
from pyspeedy_tpu.models import geopotential as jgeo
from pyspeedy_tpu.models import implicit as jimp
from pyspeedy_tpu.ops import geometry as jgeom
from pyspeedy_tpu.ops import spectral as jspec
from pyspeedy_tpu.physics.longwave_radiation import radset as jradset
from pyspeedy_tpu_torch.models import geopotential as tgeo
from pyspeedy_tpu_torch.models import implicit as timp
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.ops import geometry as tgeom
from pyspeedy_tpu_torch.ops import spectral as tspec
from pyspeedy_tpu_torch.physics.longwave_radiation import radset as tradset

# One thread for PyTorch's CPU kernels: at these sizes more threads gain
# nothing, and several test processes side by side (each with its own pool,
# next to JAX's) would fight for the cores.
torch.set_num_threads(1)

PRESETS = ["T30L8", "T30L5", "T47L8"]
TOL = 1e-14


def _close(name, got, want):
    got = np.asarray(got.cpu() if hasattr(got, "cpu") else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() / scale <= TOL, name


def _fields(name, got, want, skip=()):
    for f in want._fields:
        if f in skip:
            continue
        _close(f"{name}.{f}", getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("preset", PRESETS)
def test_geometry_tables(preset):
    _fields("geom", tgeom.build_geometry(getattr(tparams, preset)),
            jgeom.build_geometry(getattr(jparams, preset)))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("use_matmul", [False, True])
def test_spectral_tables(preset, use_matmul):
    jp, tp = getattr(jparams, preset), getattr(tparams, preset)
    want = jspec.build_spectral(jp, jgeom.build_geometry(jp),
                                use_matmul_fft=use_matmul)
    got = tspec.build_spectral(tp, tgeom.build_geometry(tp),
                               use_matmul_fft=use_matmul, device="cpu")
    assert got.use_matmul_fft == want.use_matmul_fft
    assert got.use_dense_legendre == want.use_dense_legendre
    _fields("sp", got, want, skip=("use_matmul_fft", "use_dense_legendre"))
    # T30 takes the dense Legendre operator, T47 the einsum form.
    assert got.use_dense_legendre == (use_matmul and preset != "T47L8")


@pytest.mark.parametrize("preset", PRESETS)
def test_hordif_implicit_geopot_tables(preset):
    jp, tp = getattr(jparams, preset), getattr(tparams, preset)
    jg, tg = jgeom.build_geometry(jp), tgeom.build_geometry(tp)
    jhd = jimp.build_hordif(jp, jg)
    thd = timp.build_hordif(tp, tg, device="cpu")
    _fields("hd", thd, jhd)
    # The three time steps of the start-up sequence: dt/2, dt, 2 dt.
    for dt in (0.5 * jp.delt, jp.delt, 2.0 * jp.delt):
        _fields(f"implicit[{dt}]",
                timp.build_implicit(tp, tg, thd, dt, device="cpu"),
                jimp.build_implicit(jp, jg, jhd, dt))
    jgp = jgeo.build_geopot(jp, jg)
    tgp = tgeo.build_geopot(tp, tg, device="cpu")
    _fields("gp", tgp, jgp)
    assert np.array_equal(np.asarray(tgp.xgeop1_host), np.asarray(jgp.xgeop1))


def test_radset_table():
    assert np.array_equal(tradset(), jradset())


def test_presets_match():
    import dataclasses
    for name in ("T30L8", "T30L5", "T30L7", "T47L8", "T63L8"):
        assert dataclasses.asdict(getattr(tparams, name)) == \
            dataclasses.asdict(getattr(jparams, name)), name


@pytest.mark.parametrize("preset", ["T30L8", "T30L5"])
def test_column_tables_hold_the_level_columns(preset):
    """The kernel's argument pack: device columns and their host copy hold
    the same values as the geometry and the implicit tables."""
    tp = getattr(tparams, preset)
    consts, geom_np = TM.build_consts(tp, device="cpu", physics_on=False)
    col = consts.col
    for i, (name, want) in enumerate([
            ("dhs", geom_np.dhs), ("dhsr", geom_np.dhsr),
            ("fsgr", geom_np.fsgr), ("tref", consts.implicit.tref.numpy()),
            ("tref3", consts.implicit.tref3.numpy())]):
        assert np.array_equal(getattr(col, name).numpy().ravel(), want), name
        assert np.array_equal(col.levels_host[i], want), name
    assert np.array_equal(col.rcos.numpy().ravel(), geom_np.cosgr)
    assert np.array_equal(col.coriol.numpy().ravel(), geom_np.coriol)
