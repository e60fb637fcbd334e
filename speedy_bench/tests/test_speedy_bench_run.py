"""A run of the harness on the CPU at a tiny size (the port's plain path,
no chip): the result line, and that the check catches a broken timed
path: each fault of ``faults.py``, SPPT's with SPPT on."""

import json

import pytest
import torch

from speedy_bench import run as R
from speedy_bench.cell import HERE, Cell
from speedy_bench.check import NUMBERS
from speedy_bench.faults import FAULTS

SEED = 2**31 + 977
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def tiny_cell(sppt=False) -> Cell:
    with open(HERE / "configs" / "t30l8.json") as f:
        cfg = json.load(f)
    cfg["spinup_days"] = 1
    name = "t30l8.sppt1024" if sppt else "t30l8.ens10240"
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    traffic = {"members": 4, "chunk": 2, "segment_hours": 2, "sppt": sppt,
               "perturbation": {"field": "t", "max_wavenumber": 8,
                                "std": 0.1},
               "months": 120, "samples": 2, "sample_members": 2,
               "trace_segments": 2}
    return Cell(f"{name}.tiny", cfg, traffic, limits)


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sppt", [False, True])
def test_tiny_run(sppt):
    r = R.run_cell(tiny_cell(sppt), SEED, 1.0, False, "cpu")
    assert list(r) == KEYS
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert set(r["metrics"]) == {"member_steps_per_s", "segment_p95_ms",
                                 "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["checks"]) == set(NUMBERS)
    json.loads(json.dumps(r))


@pytest.mark.parametrize("fault, sppt", [
    ("unchanged", False), ("half_left", False), ("altered", False),
    ("shared_key", True), ("no_noise", True)])
def test_broken_timed_path_is_not_correct(fault, sppt):
    r = R.run_cell(tiny_cell(sppt), SEED, 1.0, False, "cpu",
                   program_cls=FAULTS[fault])
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert R.main(["--workload", "t30l8.ens10240", "--seed", "1",
                   "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
