"""The port's profiling helpers (``pyspeedy_tpu_torch/utils/profiling.py``)
on the CPU: ``trace`` writes a Chrome trace that names the operators it saw,
and ``PhaseTimer`` keeps the JAX package's report format."""

import json
import os
import re
import time

import torch

from pyspeedy_tpu_torch.utils import profiling as P


def test_trace_writes_a_chrome_trace_naming_the_operators(tmp_path):
    a = torch.randn(64, 64, dtype=torch.float64)
    with P.trace(str(tmp_path / "tr")) as log_dir:
        torch.matmul(a, a)
    path = os.path.join(log_dir, P.TRACE_FILE)
    assert log_dir == str(tmp_path / "tr") and os.path.isfile(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


def test_trace_without_a_directory_makes_one(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    with P.trace() as log_dir:
        torch.ones(3).sum()
    assert log_dir.startswith(str(tmp_path))
    assert os.path.isfile(os.path.join(log_dir, P.TRACE_FILE))


def test_phase_timer_report_has_the_jax_format():
    """One line per phase, slowest first: the name left-aligned in 30
    columns, the seconds in 10 with 3 decimals, 's x' and the count."""
    timer = P.PhaseTimer()
    for _ in range(2):
        with timer.phase("step"):
            time.sleep(0.02)
    with timer.phase("init"):
        pass
    lines = timer.report().splitlines()
    assert [line.split()[0] for line in lines] == ["step", "init"]
    pattern = re.compile(r"^(.{30}) (.{10})s x(\d+)$")
    for line, name, count in zip(lines, ("step", "init"), (2, 1)):
        m = pattern.match(line)
        assert m, line
        assert m.group(1) == f"{name:30s}"
        assert m.group(2) == f"{timer.totals[name]:10.3f}"
        assert int(m.group(3)) == count
    assert timer.totals["step"] >= 0.04 and timer.counts["init"] == 1


def test_phase_timer_counts_a_phase_that_raised():
    timer = P.PhaseTimer()
    try:
        with timer.phase("fails"):
            raise ValueError("boom")
    except ValueError:
        pass
    assert timer.counts["fails"] == 1 and timer.totals["fails"] >= 0.0
