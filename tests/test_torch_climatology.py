"""The port's climatology check
(``pyspeedy_tpu_torch/validate_climatology.py``) on the CPU, with months cut
to one model day: both paths run (T30 through
the ``Speedy`` API from the bundled boundary conditions, the model-level
path from the synthetic ones), and the report, its checks and the exit code
follow the JAX script's logic (``validate_climatology.py`` at the root of
the repository, fed the same monthly means)."""

import importlib.util
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from pyspeedy_tpu_torch import testing
from pyspeedy_tpu_torch import validate_climatology as VC
from pyspeedy_tpu_torch.coupling.interpolation import monthly_interp
from pyspeedy_tpu_torch.models.model import build_geometry
from pyspeedy_tpu_torch.params import T30L8

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
KEYS = {"preset", "months_used", "tsfc_mean_K", "tsfc_range_K",
        "precip_mean_mm_day", "toa_net_W_m2", "checks", "ok"}
_cache = {}


def jax_script():
    """The JAX package's script, loaded by path (it imports JAX only inside
    its functions)."""
    if "jax" not in _cache:
        spec = importlib.util.spec_from_file_location(
            "jax_validate_climatology", REPO / "validate_climatology.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _cache["jax"] = mod
    return _cache["jax"]


def printed_report(text: str) -> dict:
    """The JSON report at the end of what a main() printed."""
    return json.loads(text[text.index("\n{") + 1:])


def jax_report(monkeypatch, capsys, argv, means):
    """The JAX script's report and exit code for `means`, its model runs
    replaced by a function that returns them."""
    mod = jax_script()
    seen = {}

    def fake(params, months):
        seen.update(params=params, months=months)
        return means

    monkeypatch.setattr(mod, "run_t30", fake)
    monkeypatch.setattr(mod, "run_synthetic", fake)
    monkeypatch.setattr(sys, "argv", ["validate_climatology.py"] + argv)
    capsys.readouterr()
    rc = mod.main()
    return json.loads(capsys.readouterr().out), rc, seen


def test_t30_through_the_api_matches_the_jax_scripts_logic(monkeypatch,
                                                           capsys):
    """main() on the CPU, T30 float64 through Speedy, two one-day months:
    finite means of the month used, the timer's report and the device
    printed before the JSON; the report and the exit code equal the JAX
    script's on the same means."""
    monkeypatch.setattr(VC, "DAYS_PER_MONTH", 1)
    means = {}
    real = VC.run_bundled

    def recording(params, months, **kw):
        assert params.precision == "f64" and months == 2
        means["t30"] = real(params, months, **kw)
        return means["t30"]

    monkeypatch.setattr(VC, "run_bundled", recording)
    rc = VC.main(["--months", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    report = printed_report(out)
    assert set(report) == KEYS and report["months_used"] == 1
    assert out.startswith("device: cpu; f64")
    for phase in ("set_bc", "months", "monthly means", "total"):
        assert any(line.startswith(phase) for line in out.splitlines())
    tsfc, prec, toa = means["t30"]
    assert all(math.isfinite(x) for x in tsfc + prec + toa)
    assert 250.0 < tsfc[0] < 310.0 and prec[0] > 0.0
    want, want_rc, seen = jax_report(monkeypatch, capsys, ["--months", "2"],
                                     means["t30"])
    assert report == want and rc == want_rc
    assert seen["months"] == 2


def test_synthetic_path_matches_the_jax_scripts_logic(monkeypatch, capsys):
    """run_synthetic at T30 float64 on the CPU, B=1, two one-day months;
    the report the port makes of its means, with the T47 preset's name,
    equals the JAX script's for --preset T47 on the same means."""
    monkeypatch.setattr(VC, "DAYS_PER_MONTH", 1)
    timer = VC.PhaseTimer()
    means = VC.run_synthetic(T30L8, 2, device="cpu", timer=timer)
    assert [len(x) for x in means] == [1, 1, 1]
    assert all(math.isfinite(x) for x in sum(means, []))
    assert timer.counts["months"] == 2 and timer.counts["init"] == 1
    report = VC.climate_report("T47", *means)
    want, want_rc, _ = jax_report(monkeypatch, capsys,
                                  ["--months", "2", "--preset", "T47"], means)
    assert report == want and (0 if report["ok"] else 1) == want_rc


@pytest.mark.parametrize("means", [
    ([285.0, 286.5], [2.5, 3.0], [5.0, -3.0]),       # all plausible
    ([299.0, 301.0], [2.5, 3.0], [5.0, -3.0]),       # too warm
    ([285.0, 286.0], [0.5, 0.7], [5.0, -3.0]),       # too dry
    ([285.0, 286.0], [2.5, 3.0], [45.0, 41.0]),      # TOA out of balance
])
def test_checks_and_exit_code_follow_the_jax_script(monkeypatch, capsys,
                                                    means):
    """climate_report and main()'s exit code against the JAX script for
    monthly means that pass and that fail each check."""
    monkeypatch.setattr(VC, "run_bundled", lambda *a, **k: means)
    rc = VC.main(["--months", "3", "--device", "cpu"])
    report = printed_report(capsys.readouterr().out)
    want, want_rc, _ = jax_report(monkeypatch, capsys, ["--months", "3"],
                                  means)
    assert report == want == VC.climate_report("T30", *means)
    assert rc == want_rc


def test_the_card_is_the_default_and_is_refused_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        VC.main(["--months", "1"])


class _Stop(Exception):
    pass


def test_the_synthetic_record_covers_the_run(monkeypatch):
    """run_synthetic asks for an SST anomaly record of every calendar month
    its run reaches: 13 months of 30 days from 1982-01-01 end in January
    1983, 13 months, 15 slabs with the pads. A read past the record raises
    in the port (the JAX package's three-slab synthetic record is read
    past its end there, where JAX clamps the index: a 13-month run of the
    port from that record stopped at February's second half)."""
    seen = {}

    def fake(params, **kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(testing, "make_demo_model", fake)
    with pytest.raises(_Stop):
        VC.run_synthetic(T30L8, 13, device="cpu")
    assert seen["n_months"] == 13
    monkeypatch.setattr(VC, "DAYS_PER_MONTH", 1)
    with pytest.raises(_Stop):
        VC.run_synthetic(T30L8, 2, device="cpu")
    assert seen["n_months"] == 1
    geom = build_geometry(T30L8)
    assert testing.synthetic_host_bc(T30L8, geom, 13)["sst_anom"].shape == (
        15, T30L8.il, T30L8.ix)
    assert testing.synthetic_host_bc(T30L8, geom)["sst_anom"].shape[0] == 3
    # February (month_idx 2), second half: the next slab is index 3.
    with pytest.raises(IndexError):
        monthly_interp(torch.zeros(3, 2, 2), 2, 0.75)
    assert monthly_interp(torch.ones(4, 2, 2), 2, 0.75).shape == (2, 2)
