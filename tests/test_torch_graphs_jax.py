"""The batched runner's buffer plan of ``pyspeedy_tpu_torch``
(parallel/ensemble.py::StepGraphs on CPU consts: the function the CUDA graphs
record, run eagerly) against the JAX package's batched runner, over the T30
day of tests/test_torch_graphs.py with the physics, with SPPT and on the
explicit branch. A file of its own: each configuration builds and runs a
jitted JAX day, the longest work of the CPU suite, which the test processes
then share with tests/test_torch_graphs.py; the models, the perturbation and
the port's day are that file's (imported from it).

Tolerance, relative to each field's largest absolute value, as in
tests/test_torch_step.py: 1e-8 over a run of more than a day's steps (the
order of sums differs, and the leapfrog carries the difference along).
"""

import dataclasses

import numpy as np
import pytest

from pyspeedy_tpu_torch import interop

from test_torch_graphs import (CONFIGS, N_STEPS, PROGNOSTICS, jx, models,
                               noise, perturbed, plan_day, rel_err)


@pytest.mark.parametrize("cfg", tuple(CONFIGS))
def test_buffer_plan_matches_the_jax_batched_runner(cfg):
    """The same day against the JAX package's make_run_steps_batched from
    the same state (its members' SPPT keys split as there): the
    prognostics and what the physics and the coupler write within 1e-8."""
    J = jx()
    jconsts, jstate, jcal, tconsts, _ = models(cfg)
    jb = perturbed(jstate, J.JE.broadcast_state, noise(tconsts.params),
                   lambda x: x)
    ctx, _ = J.JM.build_step_ctx(dataclasses.replace(jcal), 2, N_STEPS)
    jout = J.jax.tree.map(
        np.asarray, J.JE.make_run_steps_batched(jconsts, phase=2 % 3)(
            jb, ctx))
    tout = interop.state_to_numpy(plan_day(cfg))
    for name in PROGNOSTICS:
        for lev in range(2):
            assert rel_err(tout[name][lev], jout[name][lev]) <= 1e-8, name
    names = ["phi", "precnv", "precls", "hfluxn", "olr", "tsr", "land_temp",
             "sst_om", "tice_om", "rad_tau2"]
    if cfg == "sppt":
        names.append("sppt_spec")
    for name in names:
        assert rel_err(tout[name], jout[name]) <= 1e-8, name


