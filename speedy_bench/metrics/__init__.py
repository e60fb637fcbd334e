"""The per-layer metrics: one reader a metric, ``metrics/<name>.py`` with
``read(r) -> float | None``, where `r` is a ``Reading``. A reader that finds
nothing to read returns None, and the metric is left out of the line; a
share of a roofline or of the peak is never made up as 0."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

from .. import counts

__all__ = ["Reading", "read"]

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Reading:
    trace: object            # trace.Trace of the traced window
    params: object           # the configuration's reference ModelParams
    sppt: bool
    member_steps_per_s: float | None   # the untraced window's rate

    @property
    def peaks(self) -> dict:
        with open(HERE.parent / "peaks.json") as f:
            return json.load(f)

    def per_step_ms(self, seconds: float) -> float:
        return 1e3 * seconds / self.trace.chunk_steps

    def roofline_pct(self, layer: str) -> float | None:
        """The layer's bound over its device time, in % of the step's
        (counts/<layer>.py at the layer's peak and the memory rate)."""
        t = self.trace.by_layer.get(layer, 0.0)
        if t <= 0.0:
            return None
        flops, nbytes = counts.count(layer, self.params, self.trace.members,
                                     self.sppt)
        p = self.peaks
        bound = max(flops / p[counts.peak_key(layer, self.params)],
                    nbytes / p["hbm_bytes_per_s"])
        return 100.0 * bound * self.trace.chunk_steps / t


def read(name: str, r: Reading):
    return importlib.import_module(f"{__name__}.{name}").read(r)
