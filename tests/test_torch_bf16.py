"""The bf16_tendencies configuration of the port against the JAX package's.

With the flag, the two column kernels emit their tendency-class outputs in
bfloat16 and the direct transforms read them as 2-byte operands. There is no
card where these tests run, so what is held against JAX are the plain PyTorch
versions with the flag (the kernels are held against those on the card by
``chip_smoke.py``): ``grid_dynamics_core`` and ``grid_physics`` with the flag
against JAX's with the flag on the same float32 inputs, and a 6-step B=1 run
with the flag against the JAX batched runner with the flag.

How two bfloat16 results are compared: both sides compute in float32 and
round once. Where the float32 values agree, the rounded ones are equal; where
they differ in their last bits (another order of a few sums) and straddle a
bfloat16 tie, the results differ by one unit in the last place of bfloat16;
and an element much smaller than the field's largest value (a cancellation)
carries the float32 disagreement, 1e-6 of that largest value, whatever its own
size. So an element may differ by one bfloat16 unit or by 1e-6 of the field's
largest value, and the share of elements that differ at all stays under 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyspeedy_tpu.models import model as JM
from pyspeedy_tpu.models.tendencies import grid_dynamics_core as j_core
from pyspeedy_tpu.parallel import ensemble as JE
from pyspeedy_tpu.params import T30L8 as J_T30L8
from pyspeedy_tpu.physics import driver as JD
from pyspeedy_tpu.testing import make_demo_model as j_make_demo_model
from pyspeedy_tpu_torch import interop
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.models.tendencies import grid_dynamics_core as t_core
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8, T47L8 as T_T47L8
from pyspeedy_tpu_torch.physics import driver as TD
from pyspeedy_tpu_torch.testing import make_demo_model

# One thread for PyTorch's CPU kernels: at these sizes more threads gain
# nothing, and several test processes side by side (each with its own pool,
# next to JAX's) would fight for the cores.
torch.set_num_threads(1)

J32 = dataclasses.replace(J_T30L8, precision="f32", fft_mode="matmul")
T32 = dataclasses.replace(T_T30L8, precision="f32", fft_mode="matmul")
OUT_NAMES = ("utend", "vtend", "ttend", "trtend", "psdt_g", "flux_ut",
             "flux_vt", "flux_qu", "flux_qv", "ke")
N_STEPS = 6
_cache = {}


def jax_model():
    """The JAX package's float32 demo model (dense transform route), built
    once: its initialization compiles three jitted functions."""
    if "jax" not in _cache:
        _cache["jax"] = j_make_demo_model(J32)
    return _cache["jax"]


def torch_consts(bf16):
    key = ("consts", bf16)
    if key not in _cache:
        _cache[key] = TM.build_consts(T32, device="cpu",
                                      bf16_tendencies=bf16)[0]
    return _cache[key]


def carried_over():
    """The JAX initial state as the port's dict of float32 tensors."""
    _, jstate, _ = jax_model()
    return interop.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                    device="cpu", dtype=torch.float32)


def compare_bf16(name, got, want):
    """got: a bfloat16 tensor; want: a JAX bfloat16 array. See the module
    docstring for the criterion."""
    assert got.dtype == torch.bfloat16, (name, got.dtype)
    assert want.dtype == jnp.bfloat16, (name, want.dtype)
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want.astype(jnp.float32)).astype(np.float64)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    big = np.maximum(np.abs(g), np.abs(w))
    with np.errstate(divide="ignore"):
        unit = np.where(big > 0, 2.0 ** (np.floor(np.log2(big)) - 7), 0.0)
    diff = np.abs(g - w)
    allowed = np.maximum(unit, 1e-6 * np.abs(w).max())
    assert (diff <= allowed).all(), (name, float((diff / allowed).max()))
    share = float((diff > 0).mean())
    assert share < 1e-3, (name, share)
    return share


def test_grid_dynamics_core_with_the_flag_matches_jax():
    jconsts, _, _ = jax_model()
    jb = dataclasses.replace(jconsts, bf16_tendencies=True)
    tb = torch_consts(True)
    p = J32
    rng = np.random.default_rng(0)
    mk = lambda k, scale, mean=0.0: (
        mean + scale * rng.standard_normal((2, k, p.il, p.ix))).astype(
        np.float32)
    args = (mk(p.kx, 3e-5), mk(p.kx, 1e-5), mk(p.kx, 15.0, 250.0),
            mk(p.ntr * p.kx, 2.0, 5.0), mk(p.kx, 15.0), mk(p.kx, 10.0),
            mk(2, 2e-8))
    shape = (p.il, p.ix)
    planes = (jnp.broadcast_to(jnp.asarray(jb.sp.cosgr)[:, None], shape),
              jnp.broadcast_to(jnp.asarray(jb.geom.coriol)[:, None], shape))
    want = jax.vmap(lambda *a: j_core(jb, *a, *planes))(
        *map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    got = t_core(tb.col, *targs, bf16_out=True)
    for name, g, w in zip(OUT_NAMES, got, want):
        compare_bf16(name, g, w)
    # The cast is the last thing the function does, and the dispatcher hands
    # the flag on.
    full = t_core(tb.col, *targs)
    for g, f in zip(got, full):
        assert f.dtype == torch.float32
        assert torch.equal(g, f.to(torch.bfloat16))
    via = ck.grid_dynamics(t_core, tb.col, *targs, bf16_out=True)
    assert all(torch.equal(a, b) for a, b in zip(via, got))


def _physics_args():
    """grid_physics arguments from the carried-over demo state, as the step
    makes them: member-batched tensors for the port, and the same values
    without the member axis for JAX."""
    tconsts = torch_consts(False)
    st = TE.broadcast_state(carried_over(), 1)
    targs, tkw = TD.physics_grid_inputs(tconsts, st, True)
    assert tkw["phisg"] is None          # grid_phi is off on the CPU
    A = lambda x: jnp.asarray(x.numpy())
    drop = lambda x, nd: A(x[0] if x.dim() == nd + 1 else x)
    ug, vg, tg, qg, phig, pslg, bc, _, ablco2 = targs
    jargs = (drop(ug, 3), drop(vg, 3), drop(tg, 3), drop(qg, 3),
             drop(phig, 3), drop(pslg, 2), tuple(drop(x, 2) for x in bc), (),
             drop(ablco2, 0))
    rng = np.random.default_rng(3)
    sppt = np.clip(0.33 * rng.normal(0, 1, tuple(tg.shape)), -0.95,
                   0.95).astype(np.float32)
    return targs, jargs, sppt


@pytest.mark.parametrize("with_sppt", [False, True])
def test_grid_physics_with_the_flag_matches_jax(with_sppt):
    jconsts, _, _ = jax_model()
    jb = dataclasses.replace(jconsts, bf16_tendencies=True,
                             pallas_physics=False)
    tb = torch_consts(True)
    targs, jargs, sppt = _physics_args()
    tkw = {"sppt_pattern": torch.from_numpy(sppt)} if with_sppt else {}
    jkw = {"sppt_pattern": jnp.asarray(sppt[0])} if with_sppt else {}
    want = JD.grid_physics(jb, True, *jargs, **jkw)
    got = TD.grid_physics(tb, True, *targs, **tkw)
    for name, g, w in zip(("utend", "vtend", "ttend", "qtend"), got[:4],
                          want[:4]):
        compare_bf16(name, g[0], w)
    # The diagnostics and the radiation cache keep float32, and equal the
    # ones computed without the flag: the cast follows everything else.
    full = TD.grid_physics(torch_consts(False), True, *targs, **tkw)
    for g, f in zip(list(got[4]) + list(got[5]),
                    list(full[4]) + list(full[5])):
        assert g.dtype == torch.float32 and torch.equal(g, f)
    for g, f in zip(got[:4], full[:4]):
        assert torch.equal(g, f.to(torch.bfloat16))
    if with_sppt:
        assert not torch.equal(got[2], TD.grid_physics(tb, True, *targs)[2])


def _worst(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / (np.abs(a).max() or 1.0)


def test_six_step_run_with_the_flag_matches_jax_and_is_not_a_dead_flag():
    """B=1, 6 steps from the JAX initial state carried across: the port with
    the flag against the JAX batched runner with the flag, within the bounds
    the JAX package's own test sets between its bfloat16 and float32 runs
    (t, ps 1e-3; vor, div 5e-2 of the field's largest value); and the flag
    moves the port's trajectory away from its float32 one."""
    jconsts, jstate, jcal = jax_model()
    jb = dataclasses.replace(jconsts, bf16_tendencies=True)
    jctx, _ = JM.build_step_ctx(dataclasses.replace(jcal), 2, N_STEPS)
    out_j = JE.make_run_steps_batched(jb, phase=2)(
        dict(JE.broadcast_state(jstate, 1)), jctx)
    assert not bool(np.asarray(out_j["error_flag"]).any())

    _, _, tcal = torch_model()
    tctx, _ = TM.build_step_ctx(dataclasses.replace(tcal), 2, N_STEPS)
    start = TE.broadcast_state(carried_over(), 1)
    out_b = TE.make_run_steps_batched(torch_consts(True), device="cpu")(
        start, tctx)
    out_f = TE.make_run_steps_batched(torch_consts(False), device="cpu")(
        start, tctx)
    assert not bool(out_b["error_flag"].any())
    moved = 0.0
    for name, bound in (("t", 1e-3), ("ps", 1e-3), ("vor", 5e-2),
                        ("div", 5e-2)):
        b = out_b[name][0][0].numpy()
        assert out_b[name][0].dtype == torch.float32
        assert np.isfinite(b).all(), name
        assert _worst(np.asarray(out_j[name][0][0]), b) < bound, name
        rel = _worst(out_f[name][0][0].numpy(), b)
        assert rel < bound, name
        moved = max(moved, rel)
    assert moved > 1e-8, "bf16_tendencies had no effect (dead flag?)"


def torch_model():
    if "torch" not in _cache:
        _cache["torch"] = make_demo_model(T32, device="cpu")
    return _cache["torch"]


def test_initialization_strips_the_flag():
    """Both bootstrap steps run at full precision: a model made with the flag
    starts from the same state, bit for bit, and keeps the flag for the
    runner."""
    consts_f, state_f, _ = torch_model()
    consts_b, state_b, _ = make_demo_model(T32, device="cpu",
                                           bf16_tendencies=True)
    assert consts_b.bf16_tendencies and not consts_f.bf16_tendencies
    for name in ("vor", "div", "t", "ps", "tr"):
        for a, b in zip(state_f[name], state_b[name]):
            assert a.dtype == torch.float32 and torch.equal(a, b), name


@pytest.mark.parametrize("what", ["f64", "fft_route", "einsum_route"])
def test_build_consts_refuses_the_flag_by_name(what):
    """Where the JAX package would silently widen the bfloat16 operands
    again, the port refuses the flag."""
    params = {
        "f64": dataclasses.replace(T_T30L8, fft_mode="matmul"),
        "fft_route": dataclasses.replace(T32, fft_mode="fft"),
        "einsum_route": dataclasses.replace(T_T47L8, precision="f32",
                                            fft_mode="matmul"),
    }[what]
    match = "precision" if what == "f64" else "dense transform route"
    with pytest.raises(ValueError, match=f"bf16_tendencies.*{match}"):
        TM.build_consts(params, device="cpu", bf16_tendencies=True)


def test_cuda_wrappers_refuse_the_flag_in_float64(monkeypatch):
    monkeypatch.setattr(ck, "_load", lambda name: pytest.fail("loaded"))
    c64, _ = TM.build_consts(T_T30L8, device="cpu", physics_on=False)
    z = lambda k: torch.zeros(1, k, 48, 96, dtype=torch.float64)
    with pytest.raises((TypeError, ValueError)):
        ck.grid_dynamics_cuda(c64.col, z(8), z(8), z(8), z(8), z(8), z(8),
                              z(2), bf16_out=True)
