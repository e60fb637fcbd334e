"""The reference against the port's plain path on the CPU, at a small
size: T30 float64, the initialization and four batched steps of two
members (with SPPT), the same inputs to both."""

import json
from datetime import datetime

import pytest
import torch

from speedy_bench import inputs
from speedy_bench.cell import HERE
from speedy_bench.reference.ops.geometry import build_geometry
from speedy_bench.reference.params import ModelParams as RefParams
from speedy_bench.reference.runner import Reference

FIELDS = ("vor", "div", "t", "ps", "tr", "land_temp", "sst_am", "sppt_spec")


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


@pytest.mark.parametrize("sppt", [False, True])
def test_reference_follows_the_port(sppt):
    from pyspeedy_tpu_torch.models import model as PM
    from pyspeedy_tpu_torch.parallel.ensemble import (broadcast_state,
                                                      make_run_steps_batched)
    from pyspeedy_tpu_torch.params import ModelParams
    from pyspeedy_tpu_torch.utils.calendar import ModelCalendar

    cfg = json.load(open(HERE / "configs" / "t30l8.json"))
    prm = dict(cfg["params"], precision="f64", sppt_on=sppt)
    start = datetime.fromisoformat(cfg["start"])
    rp = RefParams(**prm)
    bc = inputs.boundary_conditions(cfg, build_geometry(rp), 2)
    ref = Reference(rp, bc, start, "cpu")

    consts, geom = PM.build_consts(ModelParams(**prm), device="cpu")
    st = PM.allocate_state(consts.params, n_months=2, device="cpu")
    cal = ModelCalendar.from_datetime(start, nsteps=consts.params.nsteps)
    st = PM.initialize(consts, st, dict(bc, _geom_np=geom), cal)
    for name in FIELDS:
        if name in st:
            for a, b in zip(*(v if isinstance(v, tuple) else (v,)
                              for v in (st[name], ref.state[name]))):
                assert rel(a, b) < 1e-10, name

    bs = broadcast_state(st, 2)
    if sppt:
        bs["sppt_key"] = inputs.sppt_keys(7, 0, 2)
    carried = {k: v for k, v in bs.items() if k in PM.CARRY_FIELDS}
    ctx, _ = PM.build_step_ctx(ModelCalendar.from_datetime(
        start, nsteps=consts.params.nsteps), 0, 4)
    out = make_run_steps_batched(consts, device="cpu")(bs, ctx)
    rout = ref.run(ref.member_state(carried), 0, 4)
    for name in FIELDS:
        if name in out:
            for a, b in zip(*(v if isinstance(v, tuple) else (v,)
                              for v in (out[name], rout[name]))):
                assert rel(a, b) < 1e-10, name


def test_sppt_keys_are_the_members_own():
    # Every member of every chunk, and the spin-up's member, draws with a
    # key of its own; the same seed gives the same keys.
    keys = torch.cat([inputs.sppt_keys(2**31 + 5, c, 64) for c in range(3)]
                     + [inputs.spinup_sppt_key()])
    assert keys.shape == (3 * 64 + 1, 2)
    assert len({tuple(k) for k in keys.tolist()}) == len(keys)
    assert torch.equal(inputs.sppt_keys(2**31 + 5, 1, 64), keys[64:128])


def test_perturbation_is_seeded_and_large_scale():
    g1 = torch.Generator().manual_seed(2**31 + 5)
    g2 = torch.Generator().manual_seed(2**31 + 5)
    spec = {"field": "t", "max_wavenumber": 8, "std": 0.1}
    a = inputs.perturbation(spec, (3, 2, 8, 31, 32), g1)
    b = inputs.perturbation(spec, (3, 2, 8, 31, 32), g2)
    assert torch.equal(a, b)
    assert (a[..., 9:, :] == 0).all() and (a[:, 1, :, 0, :] == 0).all()
