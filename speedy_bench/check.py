"""Whether the timed path produced the right forecast: its segments held
against the plain reference (``reference/``).

What is compared. The start: the program's initialized state against the
reference's own initialization from the same boundary conditions. The
window: a sample of its segments, drawn from the seed, each for a few of
its chunk's members (the first, the last and some drawn from the seed),
and the last piece of the spin-up: the reference runs the segment from the
program's state at the segment's start (the reference's own tables and
shared fields, the program's carried fields of those members, with SPPT
the benchmark's keys of those members) in float64,
and its state at the end is held against the program's. The numbers, each
the largest over the samples, members, levels and time levels:

- ``init``: ||program - reference|| / ||reference|| of t, ps and the
  tracers at the start;
- ``vor``: the same gap of the vorticity in the norm of the stream
  function (each (m, n) weighted by 1 / sqrt(l (l + 1))), over the sampled
  members: the winds, which every layer of the step moves;
- ``tmean``: |program - reference| / |reference| of a member's global mean
  temperature of a level (the spectral mean, m = n = 0): the transforms,
  the physics' heating, the spectral update;
- ``sfc``: the same of a member's mean land and sea surface temperature
  (the slab models and the coupler).

A forecast of this model is chaotic: a float32 rounding that moves a column
across a threshold of the physics (convection, condensation) grows, so the
gap of a field in the plain 2-norm, and of the divergence above all, is the
noise of those columns. The stream function's norm and the global means
average that noise out and keep what a lower precision of the whole step
leaves everywhere (``control.py`` reads both). A cell compares the numbers
that ``limits/<cell>.json`` gives a limit; a run is correct when each is
within its limit, the window was sampled and no segment failed."""

from __future__ import annotations

import math

import torch

__all__ = ["NUMBERS", "gap", "numbers", "verdict", "reference_outputs"]

NUMBERS = ("init", "vor", "tmean", "sfc")
INIT_FIELDS = ("t", "ps", "tr")
SFC_FIELDS = ("land_temp", "sst_am")


def _levels(v):
    return v if isinstance(v, tuple) else (v,)


def gap(got, want, weight=None) -> float:
    """||got - want|| / ||want|| in float64, the elements weighted by
    `weight` (broadcast) when given (0 where both are 0)."""
    got = got.double().cpu()
    want = want.double().cpu()
    if weight is not None:
        got, want = got * weight, want * weight
    num = float(torch.linalg.vector_norm(got - want))
    den = float(torch.linalg.vector_norm(want))
    if not math.isfinite(num):
        return math.inf
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return num / den


def mean_gap(got, want, spectral: bool) -> float:
    """The largest |got - want| / |want| of the means: a spectral field's
    real (m, n) = (0, 0) coefficient, a grid field's mean over the plane,
    for every member and level (the pair axis right after the members)."""
    got = got.double().cpu()
    want = want.double().cpu()
    if spectral:
        g, w = got[:, 0, ..., 0, 0], want[:, 0, ..., 0, 0]
    else:
        g, w = got.mean(dim=(-2, -1)), want.mean(dim=(-2, -1))
    d = (g - w).abs()
    if not bool(torch.isfinite(d).all()):
        return math.inf
    return float((d / w.abs().clamp_min(1e-300)).max())


def reference_outputs(ref, samples):
    """The reference's state at the end of each sampled segment (its
    "first_step", "n_steps" and the members' fields "before"), from the
    program's state at its start."""
    outs = []
    dev = ref.consts.device
    dtype = ref.params.dtype
    for s in samples:
        start = {k: tuple(a.to(dev, dtype if a.is_floating_point() else None)
                          for a in v) if isinstance(v, tuple)
                 else v.to(dev, dtype if v.is_floating_point() else None)
                 for k, v in s["before"].items()}
        end = ref.run(ref.member_state(start), s["first_step"],
                      s["n_steps"])
        outs.append({k: (tuple(a.cpu() for a in end[k])
                         if isinstance(end[k], tuple) else end[k].cpu())
                     for k in s["after"]})
    return outs


def numbers(init_got: dict, init_want: dict, samples_got, samples_want,
            el2) -> dict:
    """The numbers compared (NUMBERS); `el2` the reference's (mx, nx)
    table of l (l + 1) / a^2, which weighs the stream function's norm."""
    el2 = el2.double().cpu()
    psi = torch.where(el2 > 0, el2.clamp_min(1e-300).rsqrt(),
                      torch.zeros_like(el2))
    out = {"init": max(gap(a, b) for name in INIT_FIELDS
                       for a, b in zip(_levels(init_got[name]),
                                       _levels(init_want[name])))}
    for key in ("vor", "tmean", "sfc"):
        out[key] = 0.0
    for got, want in zip(samples_got, samples_want):
        pairs = lambda name: zip(_levels(got[name]), _levels(want[name]))
        out["vor"] = max([out["vor"]] + [gap(a, b, psi)
                                         for a, b in pairs("vor")])
        out["tmean"] = max([out["tmean"]] + [mean_gap(a, b, True)
                                             for a, b in pairs("t")])
        out["sfc"] = max([out["sfc"]] + [mean_gap(a, b, False)
                                         for name in SFC_FIELDS
                                         for a, b in pairs(name)])
    return out


def verdict(nums: dict, limits: dict, failed: int) -> tuple:
    """(correct, {name: {"value", "limit"}}) of the numbers that the cell's
    limits name: every one read and within its limit, no failed
    segment."""
    checks = {name: {"value": nums.get(name, math.inf), "limit": limit}
              for name, limit in limits.items()}
    ok = failed == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
