"""The port's bench (pyspeedy_tpu_torch/bench.py) on the CPU at its tiny
depth (--device cpu --tiny: windows of a few steps, ensembles of 2 and 4
members; with --sweep --scaling instead, the chunk sweep at 4 members and
the weak-scaling line on one gloo rank): one parseable JSON line last, with the JAX bench's keys that the
port measures and none of its XLA cost-analysis keys, the figures
consistent with each other; without a card the default device refuses to
run. Marked gpu (skipped here): the tiny bench on the card, every figure
of the card measured."""

import json
import math

import pytest
import torch

from pyspeedy_tpu_torch import bench

torch.set_num_threads(1)

TINY = bench.TINY
N = TINY.sizes
_cache = {}


def run_bench(capsys, *args):
    key = args
    if key not in _cache:
        assert bench.main(list(args)) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        _cache[key] = (lines, json.loads(lines[-1]))
    return _cache[key]


def cpu_run(capsys):
    return run_bench(capsys, "--device", "cpu", "--tiny")


def expected_keys(n_ens, n_sppt, n_hires):
    keys = {"metric", "value", "unit", "vs_baseline", "baseline_is_estimate",
            "window_sypd_min", "window_sypd_max", "card",
            f"ensemble_msps_{n_sppt}_sppt", "sppt_overhead_pct",
            f"t47_ensemble_msps_{n_hires}", f"t63_ensemble_msps_{n_hires}",
            "t63_sypd_1member"}
    for n in n_ens:
        keys |= {f"ensemble_msps_{n}", f"ensemble_device_us_per_mstep_{n}"}
        keys |= {f"ensemble_{k}_{n}" for k in bench.SUFFIXED}
    return keys


def test_the_last_line_is_one_json_object_with_the_keys(capsys):
    lines, out = cpu_run(capsys)
    assert expected_keys(N, TINY.n_sppt, TINY.n_hires) <= set(out)
    assert out["metric"] == "SYPD_T30L8_full_physics_1member_median5"
    assert out["unit"] == "simulated_years_per_wallclock_day"
    assert out["baseline_is_estimate"] is True
    assert out["card"] == "cpu" and out["precision"] == "f64"
    # Every other line before it is the bench's own.
    assert all(line.startswith("bench: ") for line in lines[:-1]
               if line.startswith("bench"))


def test_no_xla_cost_analysis_keys(capsys):
    _, out = cpu_run(capsys)
    for key in out:
        assert not any(x in key for x in ("logical_gb", "hbm_frac",
                                          "achieved_gflops", "_mfu_")), key


def test_the_figures_agree_with_each_other(capsys):
    _, out = cpu_run(capsys)
    assert out["window_sypd_min"] <= out["value"] <= out["window_sypd_max"]
    assert out["vs_baseline"] == pytest.approx(
        out["value"] / bench.REFERENCE_SYPD_ESTIMATE)
    for n in N:
        assert out[f"ensemble_msps_{n}"] > 0
        # The card's figures are not measured on the CPU.
        assert out[f"ensemble_device_us_per_mstep_{n}"] is None
    assert math.isfinite(out["sppt_overhead_pct"])
    assert out["t63_sypd_1member"] > 0


def test_the_sweep_and_the_scaling_line(capsys):
    _, out = run_bench(capsys, "--device", "cpu", "--tiny", "--sweep",
                       "--scaling")
    assert "metric" not in out      # instead of the cells
    ((preset, (members, widths)),) = TINY.sweep_cases
    sweep = out["sweep"][preset]
    assert sweep["members"] == members
    assert sorted(map(int, sweep["widths"])) == sorted(widths)
    assert int(sweep["best"]) in widths
    assert sweep["widths"][str(sweep["best"])]["msps_median"] == max(
        c["msps_median"] for c in sweep["widths"].values())
    assert out["scaling_msps_1dev"] > 0 and out["efficiency"] is None
    assert out["scaling_backend"] == "gloo"


def test_sypd_is_steps_per_day_of_simulation():
    # 36 steps a second at 36 steps a day: a day a second, 86400 / 365
    # simulated years per wall-clock day.
    assert bench.sypd(36.0, 36) == pytest.approx(86400.0 / 365.0)


def test_the_bench_refuses_to_leave_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit):
        bench.main([])


@pytest.mark.gpu
def test_the_tiny_bench_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, out = run_bench(capsys, "--tiny")
    assert expected_keys(N, TINY.n_sppt, TINY.n_hires) <= set(out)
    for n in N:
        assert out[f"ensemble_device_us_per_mstep_{n}"] > 0
        assert out[f"ensemble_peak_mb_per_member_{n}"] > 0
