"""A cell of the benchmark, read from the files that name it: the entry of
``BENCHMARK.json`` (its configuration and traffic), ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<cell>.json``."""

from __future__ import annotations

import dataclasses
import json
from datetime import datetime
from pathlib import Path

__all__ = ["Cell", "load_cell", "HERE", "ROOT"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int = 1

    @property
    def sppt(self) -> bool:
        return bool(self.traffic["sppt"])

    def params(self, params_cls):
        """The configuration's parameters as `params_cls` (the port's or the
        reference's ModelParams), with the traffic's SPPT setting."""
        return params_cls(**self.config["params"], sppt_on=self.sppt)

    @property
    def start(self) -> datetime:
        return datetime.fromisoformat(self.config["start"])

    def segment_steps(self, nsteps: int) -> int:
        hours = self.traffic["segment_hours"]
        steps = hours * nsteps / 24
        if steps != int(steps) or steps < 1:
            raise ValueError(f"{hours} h is not a whole number of steps")
        return int(steps)

    @property
    def n_chunks(self) -> int:
        members, chunk = self.traffic["members"], self.traffic["chunk"]
        if members % chunk:
            raise ValueError(f"{members} members in chunks of {chunk}")
        return members // chunk


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Cell:
    """The cell `name` of BENCHMARK.json at the root of the checkout."""
    bench = _json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(name=name,
                config=_json(HERE / "configs" / f"{entry['config']}.json"),
                traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                limits=_json(HERE / "limits" / f"{name}.json"),
                chips=entry["chips"])
