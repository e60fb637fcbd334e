"""The layers' counts against the byte and operation figures of the port's
kernel table (PERF.md, section 6, NVIDIA H100 figures at B=128 float32)."""

import dataclasses

import pytest

from speedy_bench import counts
from speedy_bench.counts import physics, transforms
from speedy_bench.reference.params import T30L8, T47L8, T63L8

f32 = lambda p: dataclasses.replace(p, precision="f32")
BW = 3.35e12


@pytest.mark.parametrize("params, mb", [(T30L8, 290.2), (T47L8, 652.9),
                                        (T63L8, 1160.8)])
def test_grid_dynamics_bytes(params, mb):
    _, nbytes = counts.count("grid_dynamics", f32(params), 128, False)
    assert nbytes / 1e6 == pytest.approx(mb, abs=0.05)


@pytest.mark.parametrize("params, mb", [(T30L8, 217.4), (T47L8, 515.4),
                                        (T63L8, 911.6)])
def test_spectral_update_bytes(params, mb):
    _, nbytes = counts.count("spectral_update", f32(params), 128, False)
    assert nbytes / 1e6 == pytest.approx(mb, abs=0.05)


@pytest.mark.parametrize("shortwave, ms", [(True, 0.1050), (False, 0.1029)])
def test_physics_bound(shortwave, ms):
    _, nbytes = physics.step_kind(f32(T30L8), 128, False, shortwave)
    assert 1e3 * nbytes / BW == pytest.approx(ms, abs=5e-5)


def test_transform_rows():
    # The step's groups at B=128: inverse 6,400 + 4,224 rows (5,248 with
    # SPPT's pattern), direct 9,344.
    inv, direct = transforms.rows(T30L8, False)
    assert (128 * inv, 128 * direct) == (6400 + 4224, 9344)
    assert 128 * transforms.rows(T30L8, True)[0] == 6400 + 5248


def test_transform_group_bytes():
    # The direct group of 9,344 rows at T30: 246.6 MB with its tables.
    il, ix, mx, nx = 48, 96, 31, 32
    p = f32(T30L8)
    row = il * ix * 4 + 2 * mx * nx * 4
    tables = (2 * ix * mx + il * mx * nx) * 4
    assert (9344 * row + tables) / 1e6 == pytest.approx(246.6, abs=0.05)
    flops, nbytes = counts.count("transforms", p, 128, False)
    assert nbytes == 128 * (83 + 73) * row + 3 * tables


@pytest.mark.parametrize("params, by", [(T30L8, "bytes"), (T63L8, "flops")])
def test_transform_bound_kind(params, by):
    # T30's transforms are bound by their bytes, T63's by their operations
    # (the folded work at 67 TFLOP/s), as the kernel table says.
    flops, nbytes = counts.count("transforms", f32(params), 128, False)
    assert (flops / 67e12 > nbytes / BW) == (by == "flops")


def test_step_sums_layers():
    p = f32(T63L8)
    total = counts.count("step", p, 7, True)
    parts = [counts.count(n, p, 7, True) for n in
             ("transforms", "grid_dynamics", "physics", "spectral_update")]
    assert total == (sum(x[0] for x in parts), sum(x[1] for x in parts))


@pytest.mark.parametrize("params, precision, key", [
    (T30L8, "f32", "float32_flops_per_s"), (T30L8, "f64", "float64_flops_per_s"),
    (T47L8, "f32", "tf32x3_flops_per_s"), (T63L8, "f32", "tf32x3_flops_per_s"),
    (T63L8, "f64", "float64_tensor_flops_per_s")])
def test_transform_peak(params, precision, key):
    # T47/T63 transforms run their DFT on the tensor cores; the other
    # layers, and the transforms at T30, outside them.
    p = dataclasses.replace(params, precision=precision)
    assert counts.peak_key("transforms", p) == key
    assert counts.peak_key("grid_dynamics", p) == (
        "float64_flops_per_s" if precision == "f64" else "float32_flops_per_s")


def test_t63_transforms_on_the_tensor_cores_are_bound_by_bytes():
    # As the kernel table says: at 3xTF32's 165 TFLOP/s every case is bound
    # by bytes.
    p = f32(T63L8)
    flops, nbytes = counts.count("transforms", p, 128, False)
    assert flops / 165e12 < nbytes / BW
