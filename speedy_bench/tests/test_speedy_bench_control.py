"""The control on the card at a small size: the reference computed in TF32
(float32 with TensorFloat-32 products), put in the program's place, fails
a limit of the cell, while the program on the same seed passes them all
(control.py reads the same at the cells' own sizes). Run on the card with
``python -m pytest speedy_bench/tests -m gpu``."""

import json

import pytest
import torch

from speedy_bench import control as C
from speedy_bench import run as R
from speedy_bench.cell import HERE, Cell


def small_cell(config: str, limits: str, sppt: bool) -> Cell:
    with open(HERE / "configs" / f"{config}.json") as f:
        cfg = json.load(f)
    with open(HERE / "limits" / f"{limits}.json") as f:
        lim = json.load(f)
    traffic = {"members": 16, "chunk": 16, "segment_hours": 6,
               "sppt": sppt, "perturbation": {"field": "t",
                                              "max_wavenumber": 8,
                                              "std": 0.1},
               "months": 120, "samples": 2, "sample_members": 4,
               "trace_segments": 4}
    return Cell(f"{limits}.small", cfg, traffic, lim)


@pytest.mark.gpu
@pytest.mark.parametrize("config, limits, sppt", [
    ("t30l8", "t30l8.ens10240", False), ("t30l8", "t30l8.sppt1024", True)])
def test_control_fails_program_passes(config, limits, sppt):
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    cell = small_cell(config, limits, sppt)
    held = {}

    def on_check(ref, samples, want, init_fields, host_bc):
        held["tf32"] = C.control_numbers(ref, samples, want, init_fields,
                                         host_bc, cell, True)

    r = R.run_cell(cell, 2**31 + 4242, 2.0, False, "cuda",
                   on_check=on_check)
    assert r["correct"] is True, r["checks"]
    assert any(v > cell.limits[k] for k, v in held["tf32"].items()), held
