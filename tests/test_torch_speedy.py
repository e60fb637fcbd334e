"""The ``Speedy`` / ``SpeedyEns`` API of ``pyspeedy_tpu_torch`` on the CPU, in
float64, mirroring tests/test_speedy.py: whole runs from the bundled boundary
conditions held against the golden fixtures (the JAX package's own float64
runs, tests/fixtures/make_fixtures.py) with the same tolerance ladder down
to rtol 1e-6, two interleaved instances, the ensemble batched against member
by member, SPPT members, failure paths, exported names, state access, the
checkpoint round trip and a checkpoint written by the JAX package, and the
grid filter. The fixtures are read, not recomputed.
"""

import dataclasses
import inspect
import os
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from pyspeedy_tpu_torch import (DEFAULT_OUTPUT_VARS, MODEL_STATE_DEF,
                                ModelParams, Speedy, SpeedyEns, T30L8,
                                example_bc_file, example_sst_anomaly_file)
from pyspeedy_tpu_torch.callbacks import (DiagnosticCheck, ModelCheckpoint,
                                          XarrayExporter)
from pyspeedy_tpu_torch.error_codes import (E_DIAGNOSTICS_OUTSIDE_RANGE,
                                            ERROR_CODES)
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.models.geopotential import hydrostatic_m0corr
from pyspeedy_tpu_torch.physics import driver as TD
from pyspeedy_tpu_torch.physics import sppt as TSP
from pyspeedy_tpu_torch.registry import MODEL_STATE_VARS
from pyspeedy_tpu_torch.utils.dataset import open_dataset

torch.set_num_threads(1)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
START = datetime(1982, 1, 1)
LADDER = (1e-1, 1e-2, 1e-3, 1e-4, 1e-6)

export_variables = (
    ["u_grid", "v_grid"],
    ["t_grid", "q_grid"],
    ["phi_grid", "ps_grid"],
    ["precnv", "precls"],
)


def fixture(name):
    return open_dataset(os.path.join(FIXTURE_DIR, name))


def assert_ds_allclose(a, b, rtol, atol=0.0):
    for v in b.keys():
        x = np.asarray(a[v].data, dtype=np.float64)
        y = np.asarray(b[v].data, dtype=np.float64)
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                   err_msg=f"variable {v}")


def new_model(end=START + timedelta(days=1), **kw):
    model = Speedy(start_date=START, end_date=end, device="cpu", **kw)
    model.set_bc()
    return model


@pytest.fixture(scope="module")
def day_run(tmp_path_factory):
    """One model day from the bundled BCs, exported by XarrayExporter; the
    model is shared by the tests that only read it."""
    out = str(tmp_path_factory.mktemp("day"))
    model = new_model()
    model.run(callbacks=[XarrayExporter(output_dir=out)])
    return model, out


def test_one_day_matches_the_fixture(day_run):
    model, out = day_run
    assert model.get_current_step() == 36
    assert model.current_date == START + timedelta(days=1)
    mine = open_dataset(os.path.join(out, "1982-01-02_0000.nc"))
    ref = fixture("1982-01-02_0000.nc")
    assert set(ref.keys()) == {"u", "v", "t", "q", "phi", "ps"}
    for rtol in LADDER:
        assert_ds_allclose(mine, ref, rtol=rtol)


def test_three_days_match_the_fixtures(tmp_path):
    """Three days, exported daily: every day's file against its fixture
    (1982-01-02, -03 and -04) down to rtol 1e-6."""
    model = new_model(START + timedelta(days=3))
    model.run(callbacks=[XarrayExporter(output_dir=str(tmp_path))])
    for day in (2, 3, 4):
        name = f"1982-01-{day:02d}_0000.nc"
        mine = open_dataset(str(tmp_path / name))
        for rtol in LADDER:
            assert_ds_allclose(mine, fixture(name), rtol=rtol)


def test_speedy_concurrent(tmp_path):
    """Two instances stepped in turns, half a day at a time, both match the
    fixture: no state leaks between instances."""
    dirs = [str(tmp_path / "run1"), str(tmp_path / "run2")]
    models = [new_model(), new_model()]
    for half in range(2):
        for model, d in zip(models, dirs):
            model.start_date = START + timedelta(hours=12 * half)
            model.end_date = START + timedelta(hours=12 * (half + 1))
            model.run(callbacks=[XarrayExporter(output_dir=d)])
    ref = fixture("1982-01-02_0000.nc")
    for d in dirs:
        assert_ds_allclose(open_dataset(os.path.join(d, "1982-01-02_0000.nc")),
                           ref, rtol=1e-6)


def test_ens_members_reproduce_the_deterministic_run(tmp_path):
    """Unperturbed members, advanced together, each match the fixture; the
    exporter writes each member under member###."""
    ens = SpeedyEns(2, start_date=START, end_date=START + timedelta(days=1),
                    device="cpu")
    for member in ens:
        member.set_bc()
    assert ens.members[0]._consts is ens.members[1]._consts
    ens.run(callbacks=[XarrayExporter(output_dir=str(tmp_path))])
    ref = fixture("1982-01-02_0000.nc")
    for m, member in enumerate(ens):
        assert_ds_allclose(member.to_dataframe().squeeze(dim="ens", drop=True),
                           ref, rtol=1e-6)
        path = tmp_path / f"member{m:03d}" / "1982-01-02_0000.nc"
        assert_ds_allclose(open_dataset(str(path)).squeeze(dim="ens",
                                                           drop=True),
                           ref, rtol=1e-6)
    merged = ens.to_dataframe()
    assert merged["t"].data.shape == (1, 2, 8, 48, 96)


def _perturbed_ens(params=T30L8, hours=6):
    ens = SpeedyEns(2, start_date=START,
                    end_date=START + timedelta(hours=hours), params=params,
                    device="cpu")
    for m in ens:
        m.set_bc()
    m1 = ens.members[1]
    m1["t_grid"] = m1["t_grid"] * (1.0 + 1e-5)
    m1.grid2spectral()
    return ens


def test_ens_batched_equals_sequential():
    """SpeedyEns batched (one member-batched run) equals member-by-member
    stepping, and the per-step physics diagnostics are current after a
    batched run."""
    ens_a, ens_b = _perturbed_ens(), _perturbed_ens()
    olr0 = ens_a.members[0]["olr"]
    ens_a.run(batched=True)
    ens_b.run(batched=False)
    for m in range(2):
        np.testing.assert_allclose(
            ens_a.members[m]["t_grid"], ens_b.members[m]["t_grid"],
            rtol=0, atol=1e-11, err_msg=f"member {m}")
        for name in TD.DIAG_FIELDS:
            a, b = ens_a.members[m][name], ens_b.members[m][name]
            assert np.abs(a - b).max() <= 1e-9 * max(np.abs(b).max(), 1.0), \
                (name, m)
    assert np.abs(ens_a.members[0]["olr"] - olr0).max() > 1e-3, \
        "diagnostics look like initialization-time values"
    assert np.abs(ens_a.members[0]["t_grid"]
                  - ens_a.members[1]["t_grid"]).max() > 1e-6
    assert ens_a.get_current_step() == 9 == ens_b.get_current_step()


def test_sppt_ensemble_members_distinct():
    """SPPT members carry distinct keys (fold_in(key(0), member)), so
    unperturbed members diverge through the stochastic physics alone; the
    batched run equals the member-by-member run."""
    params = dataclasses.replace(T30L8, sppt_on=True)
    runs = []
    for batched in (True, False):
        ens = SpeedyEns(2, start_date=START,
                        end_date=START + timedelta(hours=6), params=params,
                        device="cpu")
        for m in ens:
            m.set_bc()
        keys = [m._state["sppt_key"] for m in ens]
        for m, key in enumerate(keys):
            assert torch.equal(key, TSP.fold_in(TSP.key_data(0), m))
        ens.run(batched=batched)
        for m in ens:
            m.spectral2grid()
        runs.append([m["t_grid"] for m in ens])
    d = np.abs(runs[0][0] - runs[0][1]).max()
    assert d > 1e-8, "SPPT members did not diverge"
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-11)


def test_exceptions():
    """Zeroed spectral T trips the check, and the error flag raised in a run
    comes out as RuntimeError with the error code's message; misuse is
    refused."""
    model = new_model(START + timedelta(hours=2))
    t0 = model["t"]
    t = t0.copy()
    t[:] = 0
    model["t"] = t
    with pytest.raises(RuntimeError,
                       match=ERROR_CODES[E_DIAGNOSTICS_OUTSIDE_RANGE]):
        model.check()
    # A global-mean temperature far below the accepted range (about 125 K)
    # stays finite through a step and sets the error flag there.
    model["t"] = 0.5 * t0
    with pytest.raises(RuntimeError,
                       match=ERROR_CODES[E_DIAGNOSTICS_OUTSIDE_RANGE]):
        model.run()
    assert model.get_current_step() == 3
    with pytest.raises(RuntimeError, match="already initialized"):
        model.set_bc()
    with pytest.raises(ValueError):
        Speedy(start_date=START + timedelta(days=1), end_date=START,
               device="cpu")
    fresh = Speedy(start_date=START, end_date=START + timedelta(hours=1),
                   device="cpu")
    with pytest.raises(RuntimeError, match="set_bc"):
        fresh.run()
    with pytest.raises(RuntimeError, match="does not exist"):
        fresh.set_bc(bc_file="/nonexistent/bc.nc")
    other = Speedy(start_date=START, end_date=START + timedelta(hours=1),
                   device="cpu")
    with pytest.raises(TypeError):
        other.set_bc(sst_anomaly=3)
    late = Speedy(start_date=datetime(2030, 1, 1),
                  end_date=datetime(2030, 1, 2), device="cpu")
    with pytest.raises(RuntimeError, match="months are missing"):
        late.set_bc()


@pytest.mark.parametrize("variables", export_variables)
def test_speedy_variable_export(variables, day_run, tmp_path):
    """Exported variable names strip the _grid suffix via alt_name."""
    model, _ = day_run
    XarrayExporter(output_dir=str(tmp_path), variables=variables)(model)
    ds = open_dataset(str(tmp_path / "1982-01-02_0000.nc"))
    assert set(v.replace("_grid", "") for v in variables) == set(ds.keys())


def test_callbacks(day_run):
    """ModelCheckpoint gathers a time series, DiagnosticCheck passes a sound
    state, and the interval gates both."""
    model, _ = day_run
    ck = ModelCheckpoint(interval=36)
    ck(model)
    ck(model)
    assert ck.dataframe["t"].data.shape == (1, 8, 48, 96)
    assert set(ck.dataframe.keys()) == {"u", "v", "t", "q", "phi", "ps"}
    DiagnosticCheck(interval=36)(model)
    assert ModelCheckpoint(interval=5).skip_flag(model)
    assert tuple(DEFAULT_OUTPUT_VARS) == ("u_grid", "v_grid", "t_grid",
                                          "q_grid", "phi_grid", "ps_grid")


def test_state_get_set_roundtrip(day_run):
    """Dict-style state access round-trips through the Fortran-order API
    layout; a wrong shape and an unknown name are refused."""
    model, _ = day_run
    for name in ("vor", "t_grid", "ps_grid", "stl12", "slru", "rad_tau2",
                 "tr", "phis", "increase_co2", "fband"):
        arr = model[name]
        if MODEL_STATE_DEF[name]["dims"]:
            assert arr.shape == model.get_shape(name), name
        model[name] = arr
        np.testing.assert_array_equal(model[name], arr, err_msg=name)
    assert np.iscomplexobj(model["vor"])
    assert model["vor"].shape == (31, 32, 8, 2)
    with pytest.raises(ValueError):
        model["t_grid"] = np.zeros((1, 2, 3))
    with pytest.raises(AttributeError):
        model["not_a_var"]
    assert model["current_step"] == 36


@pytest.mark.parametrize("name", ["vor", "tr", "t_grid", "slru", "phis"])
def test_api_arrays_of_a_member_batched_state(name, day_run):
    """to_api_array of a member-batched state (batched=True) keeps the
    member axis first: member m's slice is member m's API array; and
    from_api_array inverts the single-member conversion."""
    from pyspeedy_tpu_torch.registry import REGISTRY, from_api_array, \
        to_api_array
    model, _ = day_run
    spec = REGISTRY[name]
    val = model._state[name]
    grow = lambda a: torch.stack([a, 2.0 * a])
    batched = (tuple(grow(a) for a in val) if isinstance(val, tuple)
               else grow(val))
    both = to_api_array(spec, batched, batched=True)
    one = to_api_array(spec, val)
    assert both.shape == (2,) + one.shape == (2,) + model.get_shape(name)
    assert np.array_equal(both[0], one) and np.array_equal(both[1], 2 * one)
    back = from_api_array(spec, one)
    back = back if isinstance(back, tuple) else (back,)
    for b, v in zip(back, val if isinstance(val, tuple) else (val,)):
        assert np.array_equal(b, v.numpy())


def test_all_registry_variables_accessible(day_run):
    model, _ = day_run
    for spec in MODEL_STATE_VARS:
        arr = model[spec.name]
        if spec.dims:
            assert np.asarray(arr).shape == model.get_shape(spec.name), \
                spec.name
    assert set(MODEL_STATE_DEF) == {s.name for s in MODEL_STATE_VARS}


def test_checkpoint_roundtrip(tmp_path):
    """save_checkpoint / load_checkpoint restores the trajectory bitwise."""
    end = START + timedelta(hours=24)
    model = new_model(end)
    model._advance(9)
    ckpt = str(tmp_path / "state.npz")
    model.save_checkpoint(ckpt)
    model._advance(9)
    ref_t = model["t_grid"].copy()
    model2 = new_model(end)
    model2.load_checkpoint(ckpt)
    assert model2.get_current_step() == 9
    assert model2.current_date == START + timedelta(hours=6)
    model2._advance(9)
    np.testing.assert_array_equal(model2["t_grid"], ref_t)


def test_loads_a_checkpoint_of_the_jax_package(tmp_path):
    """The JAX package's Speedy after set_bc, saved by its save_checkpoint:
    the port loads every field of it exactly, and its own set_bc state
    agrees with the JAX one to 1e-10 (the same initialization)."""
    import jax

    from pyspeedy_tpu.speedy import Speedy as JSpeedy

    jmodel = JSpeedy(start_date=START, end_date=START + timedelta(days=1))
    jmodel.set_bc()
    ckpt = str(tmp_path / "jax.npz")
    jmodel.save_checkpoint(ckpt)
    jstate = jax.tree.map(np.asarray, jmodel._state)

    model = new_model()
    own = {k: (tuple(a.clone() for a in v) if isinstance(v, tuple)
               else v.clone()) for k, v in model._state.items()}
    model.load_checkpoint(ckpt)
    assert model.get_current_step() == 0
    with np.load(ckpt) as data:
        loaded = 0
        for name, val in model._state.items():
            if name not in data.files:
                continue
            got = (np.stack([a.numpy() for a in val])
                   if isinstance(val, tuple) else val.numpy())
            assert np.array_equal(got, data[name]), name
            loaded += 1
    assert loaded > 100
    for name, want in jstate.items():
        if name not in own:
            continue
        got = own[name]
        for g, w in (zip(got, want) if isinstance(want, tuple)
                     else [(got, want)]):
            g, w = g.numpy(), np.asarray(w)
            if w.dtype.kind == "f":
                scale = np.abs(w).max() or 1.0
                assert np.abs(g - w).max() <= 1e-10 * scale, name
            else:
                assert np.array_equal(g, w), name
    model._advance(3)
    model._raise_if_failed()


def test_apply_grid_filter():
    model = new_model(START + timedelta(hours=1))
    model.spectral2grid()
    before = model["t_grid"].copy()
    model.apply_grid_filter()
    after = model["t_grid"]
    # The reference's transforms are non-orthogonal, so even an
    # already-truncated field changes by up to ~2% near the poles, but not
    # more, and the bulk of the field is intact.
    scale = np.abs(before).max()
    diff = np.abs(after - before)
    assert 0 < diff.max() / scale < 0.05
    assert np.sqrt((diff**2).mean()) / scale < 0.005


def test_api_defaults_to_the_card_and_bundled_files():
    """Speedy and SpeedyEns default to device="cuda" and refuse without a
    card; the bundled files exist; the package exports the JAX package's
    API names."""
    for cls in (Speedy, SpeedyEns):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    assert os.path.isfile(example_bc_file())
    assert os.path.isfile(example_sst_anomaly_file())
    assert isinstance(T30L8, ModelParams)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        Speedy()
    with pytest.raises(RuntimeError, match="cuda"):
        SpeedyEns(2)


def test_speedy_runs_the_batched_runner(day_run):
    """Speedy is the B = 1 case of the member-batched runner: one member
    through make_run_steps_batched from the state after set_bc gives the
    same state as Speedy's own run, bitwise."""
    model = new_model(START + timedelta(hours=4))
    st = TM.add_member_axis(model._state, 1)
    ctx, _ = TM.build_step_ctx(dataclasses.replace(model._cal), 0, 6)
    from pyspeedy_tpu_torch.parallel.ensemble import make_run_steps_batched
    out = make_run_steps_batched(model._consts, device="cpu")(st, ctx)
    model.run()
    assert model.get_current_step() == 6
    for name in ("vor", "t", "tr"):
        assert torch.equal(out[name][0][0], model._state[name][0]), name


def test_m0corr_does_not_depend_on_the_batch():
    """The grid_phi m=0 correction of a member is the same bits whether it
    is computed alone or beside others (on the card a matrix product here
    took another algorithm at another batch width)."""
    consts, _ = TM.build_consts(T30L8, device="cpu", grid_phi=True)
    rng = np.random.default_rng(4)
    t = torch.from_numpy(rng.standard_normal((5, 2, 8, 31, 32)))
    together = hydrostatic_m0corr(consts.gp, consts.sp, t)
    for m in range(5):
        assert torch.equal(together[m:m + 1],
                           hydrostatic_m0corr(consts.gp, consts.sp,
                                              t[m:m + 1])), m


@pytest.mark.gpu
def test_ensemble_batched_equals_one_by_one_on_the_card():
    """Needs an NVIDIA GPU and nvcc: float32 SpeedyEns with SPPT, 9 steps,
    three members advanced together against two advanced one at a time:
    members 0 and 1 bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    params = dataclasses.replace(T30L8, precision="f32", sppt_on=True)
    runs = []
    for n, batched in ((3, True), (2, False)):
        ens = SpeedyEns(n, start_date=START,
                        end_date=START + timedelta(hours=6), params=params)
        for m in ens:
            m.set_bc()
        ens.run(batched=batched)
        runs.append(ens)
    for a, b in zip(runs[0].members[:2], runs[1].members):
        for name in ("vor", "div", "t", "ps", "tr"):
            assert torch.equal(a._state[name][0], b._state[name][0]), name


@pytest.mark.gpu
def test_speedy_on_the_card_matches_the_fixture(tmp_path):
    """Needs an NVIDIA GPU and nvcc: one float64 day of Speedy on the card
    (the kernels) against the fixture, down to rtol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    model = Speedy(start_date=START, end_date=START + timedelta(days=1),
                   device="cuda")
    model.set_bc()
    model.run(callbacks=[XarrayExporter(output_dir=str(tmp_path))])
    mine = open_dataset(str(tmp_path / "1982-01-02_0000.nc"))
    for rtol in LADDER:
        assert_ds_allclose(mine, fixture("1982-01-02_0000.nc"), rtol=rtol)
