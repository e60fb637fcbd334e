"""Boundary fields on another Gaussian grid than the model's
(``pyspeedy_tpu_torch/coupling/remap.py``) and the T63L8 path they open, on
the CPU in float64: the model's own grid is taken as it is, the remap from
T30 to T63 keeps each field's global mean and stays within its source's
range, the benchmark's T63 file is the writer's output, ``Speedy`` and
``SpeedyEns`` at T63L8 initialise from the bundled file as the model's
initialization does from the remapped fields, and the port there follows
the benchmark's plain reference."""

import json
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from pyspeedy_tpu_torch import Speedy, SpeedyEns, example_bc_file
from pyspeedy_tpu_torch.coupling import remap as R
from pyspeedy_tpu_torch.models import model as M
from pyspeedy_tpu_torch.models import prognostics as prog
from pyspeedy_tpu_torch.ops.spectral import gaussian_nodes_and_weights
from pyspeedy_tpu_torch.params import T30L8, T63L8
from pyspeedy_tpu_torch.utils import profiling as P
from pyspeedy_tpu_torch.utils.calendar import ModelCalendar
from speedy_bench.cell import HERE as BENCH

torch.set_num_threads(1)

T30, T63 = (T30L8.il, T30L8.ix), (T63L8.il, T63L8.ix)
FIELDS = sorted(R.NC_NAMES)
EPS = np.finfo(np.float64).eps
_cache = {}


def source():
    """The bundled file's fields, each filled, and their filled counts."""
    if "src" not in _cache:
        raw, _ = R.read_bc(example_bc_file())
        _cache["src"] = {k: R.fill_field(k, v) for k, v in raw.items()}
    return _cache["src"]


def gaussian_weights(nlat):
    _, w = gaussian_nodes_and_weights(nlat // 2)
    return np.concatenate([w, w[::-1]])


def global_mean(field):
    """Each plane's Gaussian-weighted mean (equal longitudes)."""
    w = gaussian_weights(field.shape[-2])[:, None]
    return (field * w).sum(axis=(-2, -1)) / (w.sum() * field.shape[-1])


def leaves(v):
    return v if isinstance(v, tuple) else (v,)


def assert_same_state(got, want):
    assert got.keys() == want.keys()
    for name in want:
        for a, b in zip(leaves(got[name]), leaves(want[name])):
            assert torch.equal(a, b), name


def initialized(params, fields, sst_anom):
    """models/model.py::initialize from host fields on the CPU, its grid
    fields made from its spectra as set_bc makes them."""
    consts, geom = M.build_consts(params, device="cpu")
    state = M.allocate_state(params, n_months=sst_anom.shape[0] - 2,
                             device="cpu")
    cal = ModelCalendar.from_datetime(datetime(1982, 1, 1),
                                      nsteps=params.nsteps)
    state = M.initialize(consts, state, dict(fields, sst_anom=sst_anom,
                                             _geom_np=geom), cal)
    return prog.spectral2grid(consts, state)


def test_the_models_own_grid_is_taken_as_it_is(monkeypatch):
    """T30 from the bundled T30 file: the remap is not called, and the
    state is bitwise what the initialization gives from the file's fields
    as read."""
    def refuse(*a, **k):
        raise AssertionError("remap_bc called on the model's own grid")

    monkeypatch.setattr(R, "remap_bc", refuse)
    model = Speedy(device="cpu")
    model.set_bc()
    raw, _ = R.read_bc(example_bc_file())
    assert R.off_grid(dict(raw, sst_anom=model._sst_anom_data), *T30) == []
    want = initialized(T30L8, raw, model._sst_anom_data)
    got = dict(model._state)
    assert_same_state({k: got[k] for k in want}, want)


@pytest.mark.parametrize("name", FIELDS)
def test_remap_keeps_the_global_mean(name):
    """T30 -> T63: each month of each filled field keeps its
    Gaussian-weighted global mean to 1e-12 (the overlaps' sums are exact to
    rounding); the land-sea mask's mean is the land area."""
    field, _ = source()[name]
    out = R.remap_field(field, R.remap_weights(T30, T63))
    assert out.shape == field.shape[:-2] + T63
    src, dst = global_mean(field), global_mean(out)
    assert np.all(np.abs(dst - src) <= 1e-12 * np.abs(src))
    if name == "fmask_orig":
        assert 0.25 < float(dst) < 0.35       # Earth's land, ~29 %


@pytest.mark.parametrize("name", FIELDS)
def test_remapped_values_lie_within_the_sources_range(name):
    """Every value is a mean of source values with weights summing to 1:
    within the filled source's [min, max], up to the rounding of that sum
    (a few units in the last place)."""
    field, _ = source()[name]
    out = R.remap_field(field, R.remap_weights(T30, T63))
    lo, hi = field.min(), field.max()
    tol = 8 * EPS * max(abs(lo), abs(hi))
    assert out.min() >= lo - tol and out.max() <= hi + tol
    assert np.all(field < R.MISSING)


def test_the_fill_supplies_the_missing_points():
    """The bundled file marks land for the sea fields and sea for the land
    fields as missing: after the fill none is left, and the points filled
    are those marked."""
    raw, _ = R.read_bc(example_bc_file())
    for name, (field, n) in source().items():
        assert n == int((raw[name] >= R.MISSING).sum())
        assert np.all(np.isfinite(field)) and np.all(field < R.MISSING)
    assert source()["orog"][1] == 0 and source()["sst12"][1] > 0
    anom = np.full((3, 2, 4), -0.5)
    anom[1, 0, 0] = 9.969e36
    filled, n = R.fill_field(R.ANOMALY, anom)
    assert n == 1 and filled[1, 0, 0] == 0.0 and filled.min() == -0.5


def test_the_benchmarks_t63_file_is_the_writers_output(tmp_path):
    """speedy_bench/data/bc_t63.nc is what the writer makes of the
    benchmark's copy of the bundled file, variable for variable."""
    out = tmp_path / "bc_t63.nc"
    R.main(["--preset", "T63", str(BENCH / "data" / "example_bc.nc"),
            str(out)])
    from pyspeedy_tpu_torch.utils.dataset import open_dataset

    got, want = open_dataset(str(out)), open_dataset(
        str(BENCH / "data" / "bc_t63.nc"))
    assert sorted(got.keys()) == sorted(want.keys())
    for name in want.keys():
        assert got[name].dims == want[name].dims, name
        assert got[name].values.dtype == want[name].values.dtype, name
        assert np.array_equal(got[name].values, want[name].values), name
    assert want["sst"].values.shape == (T63[1], T63[0], 12)


def t63_expected():
    """The T63L8 state that the initialization gives from the remapped
    bundled fields and SST anomalies (the anomalies as Speedy selects
    them)."""
    if "t63" not in _cache:
        probe = Speedy(params=T63L8, device="cpu")
        probe._set_sst_anomalies()
        raw, _ = R.read_bc(example_bc_file())
        fields = R.remap_bc(dict(raw, sst_anom=probe._sst_anom_data), *T63)
        anom = fields.pop("sst_anom")
        _cache["t63"] = initialized(T63L8, fields, anom)
    return _cache["t63"]


def test_speedy_at_t63_initialises_from_the_remapped_file():
    """Speedy(params=T63L8).set_bc() with the bundled T30 files: the state
    of the initialization from the remapped fields; the store counts the
    twelve fields and the anomalies remapped and the points filled."""
    P.reset_spans()
    model = Speedy(params=T63L8, device="cpu")
    model.set_bc()
    t = P.span_totals()
    assert t["remap_fields"] == 13
    assert t["remap_filled_points"] == sum(n for _, n in source().values())
    want = t63_expected()
    got = dict(model._state)
    assert_same_state({k: got[k] for k in want}, want)
    assert model["t_grid"].shape == (T63[1], T63[0], T63L8.kx)
    P.reset_spans()


def test_speedy_ens_at_t63_takes_the_same_path():
    """SpeedyEns members at T63L8 initialise as Speedy does and advance
    together through the batched runner."""
    start = datetime(1982, 1, 1)
    ens = SpeedyEns(2, start_date=start,
                    end_date=start + timedelta(seconds=2 * 1200),
                    params=T63L8, device="cpu")
    for member in ens:
        member.set_bc()
    want = t63_expected()
    for member in ens:
        assert_same_state({k: member._state[k] for k in want}, want)
    ens.run()
    assert ens.get_current_step() == 2
    for member in ens:
        assert not bool(member._state["error_flag"])
        assert torch.isfinite(member._state["vor"][0]).all()


def test_the_port_at_t63_follows_the_plain_reference():
    """T63L8 float64 from the benchmark's remapped file: the port's
    initialization (with its two bootstrap steps) and two leapfrog steps of
    two members perturbed from a seed, against speedy_bench/reference/ (a
    frozen plain copy that imports neither the port nor JAX). The bound is
    the benchmark's float64 one at T30 (1e-10): both run the same
    arithmetic in float64, apart in the order of the sums only."""
    from speedy_bench import inputs
    from speedy_bench.reference.ops.geometry import build_geometry
    from speedy_bench.reference.params import ModelParams as RefParams
    from speedy_bench.reference.runner import Reference
    from pyspeedy_tpu_torch.parallel.ensemble import (broadcast_state,
                                                      make_run_steps_batched)
    from pyspeedy_tpu_torch.params import ModelParams

    cfg = json.loads((BENCH / "configs" / "t63l8.json").read_text())
    prm = dict(cfg["params"], precision="f64")
    start = datetime.fromisoformat(cfg["start"])
    rp = RefParams(**prm)
    bc = inputs.boundary_conditions(cfg, build_geometry(rp), 2)
    ref = Reference(rp, bc, start, "cpu")
    params = ModelParams(**prm)
    for key in ("trunc", "ix", "iy", "kx", "nsteps", "thd", "thdd", "thds"):
        assert getattr(params, key) == getattr(T63L8, key), key
    st = initialized(params, {k: v for k, v in bc.items()
                              if k != "sst_anom"}, bc["sst_anom"])

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm().clamp_min(1e-300))

    fields = ("vor", "div", "t", "ps", "tr", "land_temp", "sst_am")
    for name in fields:
        for a, b in zip(leaves(st[name]), leaves(ref.state[name])):
            assert rel(a, b) < 1e-10, name

    gen = torch.Generator().manual_seed(2**31 + 63)
    bs = broadcast_state(st, 2)
    spec = {"field": "t", "max_wavenumber": 8, "std": 0.1}
    dx = inputs.perturbation(spec, tuple(bs["t"][0].shape), gen)
    bs["t"] = tuple(lv + dx for lv in bs["t"])
    carried = {k: v for k, v in bs.items() if k in M.CARRY_FIELDS}
    ctx, _ = M.build_step_ctx(ModelCalendar.from_datetime(
        start, nsteps=params.nsteps), 0, 2)
    consts, _ = M.build_consts(params, device="cpu")
    out = make_run_steps_batched(consts, device="cpu")(bs, ctx)
    rout = ref.run(ref.member_state(carried), 0, 2)
    for name in fields:
        for a, b in zip(leaves(out[name]), leaves(rout[name])):
            assert a.shape[0] == 2
            assert rel(a, b) < 1e-10, name
    assert not torch.equal(out["t"][0][0], out["t"][0][1])
