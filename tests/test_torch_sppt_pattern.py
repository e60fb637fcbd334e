"""The SPPT pattern of ``pyspeedy_tpu_torch`` without the JAX package: its
statistics, which the JAX package does not test (the standard deviation,
lag-1 autocorrelation and correlation length of the reference's
sppt.f90:49-51), the consts and state it needs, and on the card the physics'
transform group with the pattern and a float64 SPPT day against the CPU.
No JAX import, so that `python -m pytest tests/test_torch_sppt_pattern.py -m
gpu` runs on the card's machine. Parity with the JAX package is in
tests/test_torch_sppt.py.
"""

import dataclasses
import math
import weakref

import numpy as np
import pytest
import torch

from pyspeedy_tpu_torch import constants as pc
from pyspeedy_tpu_torch import interop
from pyspeedy_tpu_torch.models import model as TM
from pyspeedy_tpu_torch.ops import column_kernels as ck
from pyspeedy_tpu_torch.ops import spectral as TS
from pyspeedy_tpu_torch.ops import transform_kernels as TK
from pyspeedy_tpu_torch.parallel import ensemble as TE
from pyspeedy_tpu_torch.params import T30L8 as T_T30L8
from pyspeedy_tpu_torch.physics import driver as TD
from pyspeedy_tpu_torch.physics import sppt as TSP
from pyspeedy_tpu_torch.testing import make_demo_model

torch.set_num_threads(1)

T_SPPT = dataclasses.replace(T_T30L8, sppt_on=True)
PROGNOSTICS = ("vor", "div", "t", "ps", "tr")
_cache = {}


def torch_consts():
    if "tconsts" not in _cache:
        _cache["tconsts"] = TM.build_consts(T_SPPT, device="cpu")[0]
    return _cache["tconsts"]


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / scale if scale > 0 else \
        np.abs(got).max()


def test_statistics_of_the_pattern():
    """Not tested by the JAX package: over 40 steps of 4 members from the
    stationary state, the clipped grid pattern has the reference's standard
    deviation, lag-1 autocorrelation exp(-dt / 6 h) and 500 km correlation
    length.

    The standard deviation is held in the reference's normalization of the
    spectral basis, in which sppt.f90's amplitude formula gives 0.33: there
    every harmonic has a mean square of 1 over the sphere, while this
    model's (the reference's own transforms) has 1/2 (the (0, 0) harmonic is
    1/sqrt(2) everywhere, checked below). So the pattern on this grid has a
    standard deviation of 0.33/sqrt(2), in the reference, the JAX package
    and here alike; the test holds std * sqrt(2) to 0.33 +- 0.03."""
    tconsts = torch_consts()
    sp, p = tconsts.sp, T_SPPT
    unit = torch.zeros((2, 1, p.mx, p.nx), dtype=torch.float64)
    unit[0, 0, 0, 0] = 1.0
    y00 = TS.spec2grid_p(sp, unit, 1, 0)
    assert torch.allclose(y00, torch.full_like(y00, 0.5**0.5), atol=1e-14)
    basis_rms = float(y00.pow(2).mean().sqrt())

    n_steps, nmem = 40, 4
    keys = TSP.split_keys(TSP.key_data(0), nmem)
    state = {"sppt_key": keys,
             "sppt_spec": TSP.stationary_draw(tconsts, keys)}
    pats, _ = TSP.gen_sppt_n(tconsts, state, n_steps, 2)
    assert float(pats.abs().max()) <= 1.0
    std = float(pats.std())
    assert abs(std / basis_rms - TSP.STDDEV) <= 0.03, std

    a = pats[1:].reshape(-1)
    b = pats[:-1].reshape(-1)
    lag1 = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    phi = math.exp(-(24.0 / p.nsteps) / TSP.TIME_DECORR)
    assert abs(lag1 - phi) <= 0.02, (lag1, phi)

    # Spectral e-folding: the grid patterns' coefficient variance against
    # total wavenumber l falls as exp(-0.5 (L / a)^2 l (l + 1)).
    spec = TS.grid2spec_p(sp, pats.reshape(-1, p.il, p.ix), 0).numpy()
    m = np.arange(p.mx)[:, None]
    ell = m + np.arange(p.nx)[None, :]
    ells = np.arange(1, p.trunc + 1)
    var = [np.mean(np.concatenate([spec[0][:, ell == l].ravel(),
                                   spec[1][:, (ell == l) & (m > 0)].ravel()])
                   ** 2) for l in ells]
    fit = np.polyfit(ells * (ells + 1.0), np.log(var), 1)
    length = math.sqrt(-2.0 * fit[0]) * pc.REARTH
    assert abs(length / TSP.LEN_DECORR - 1.0) <= 0.05, length


def test_consts_state_and_interop_with_sppt():
    """build_consts(sppt_on) builds with the physics on or off;
    allocate_state carries the spectrum and the key; broadcast_state gives
    each member its own key; the key crosses to the JAX package as uint32
    key data and back."""
    for physics_on in (True, False):
        consts, _ = TM.build_consts(T_SPPT, device="cpu",
                                    physics_on=physics_on)
        assert consts.sppt is not None
    st = TM.allocate_state(T_SPPT, device="cpu")
    assert st["sppt_spec"].shape == (2, 8, 31, 32)
    assert st["sppt_key"].tolist() == [0, 0]
    b = TE.broadcast_state(st, 3)
    assert b["sppt_spec"].shape == (3, 2, 8, 31, 32)
    assert len({tuple(k) for k in b["sppt_key"].tolist()}) == 3
    back = interop.state_to_numpy(b)
    assert back["sppt_key"].dtype == np.uint32
    again = interop.state_from_numpy(back, device="cpu")
    assert torch.equal(again["sppt_key"], b["sppt_key"])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

class _ChunkWatch:
    """Stands in for physics/sppt.py::_draw_steps: records each chunk's
    steps and, at every draw, how many earlier chunks are still alive."""

    def __init__(self):
        self.draw = TSP._draw_steps
        self.chunks = []
        self.steps = []
        self.alive_at_draw = []

    def __call__(self, *args):
        self.alive_at_draw.append(sum(r() is not None for r in self.chunks))
        chunk = self.draw(*args)
        self.chunks.append(weakref.ref(chunk))
        self.steps.append(chunk.shape[1])
        return chunk


def _watch_chunks(monkeypatch, steps_per_chunk, per, nmem):
    watch = _ChunkWatch()
    monkeypatch.setattr(TSP, "_draw_steps", watch)
    monkeypatch.setattr(TSP, "MAX_DRAW_ELEMENTS", steps_per_chunk * per * nmem)
    return watch


def test_run_noise_is_drawn_a_chunk_at_a_time(monkeypatch):
    """A long run call's noise, drawn in chunks of 3 steps as the caller
    uses it, equals the one-pass draw bitwise, and no earlier chunk is
    alive when the next is drawn: the noise held does not grow with the
    run's length."""
    tconsts = torch_consts()
    keys = TSP.split_keys(TSP.key_data(0), 2)
    per = 2 * 8 * 31 * 32
    whole = list(TSP.draw_run_noise(tconsts, keys, 1, 40))
    watch = _watch_chunks(monkeypatch, 3, per, 2)
    noise = TSP.draw_run_noise(tconsts, keys, 1, 40)
    for step in range(40):
        got = next(noise)
        assert torch.equal(got, whole[step]), step
        del got                     # as the runner drops a used step
    assert watch.steps == [3] * 13 + [1]
    assert watch.alive_at_draw == [0] * 14


def test_runner_draws_its_noise_a_chunk_at_a_time(monkeypatch):
    """The batched runner with SPPT over 8 steps at B=2: with the noise
    drawn two steps at a time the state equals that of the one-pass draw
    bitwise, and at every draw no earlier chunk is alive."""
    consts, state, cal = make_demo_model(T_SPPT, device="cpu")
    run = TE.make_run_steps_batched(consts, device="cpu")
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, 8)
    whole = run(TE.broadcast_state(state, 2), ctx)
    watch = _watch_chunks(monkeypatch, 2, 2 * 8 * 31 * 32, 2)
    chunked = run(TE.broadcast_state(state, 2), ctx)
    assert watch.steps == [2] * 4
    assert watch.alive_at_draw == [0] * 4
    for name in PROGNOSTICS + ("sppt_spec",):
        a, b = whole[name], chunked[name]
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), name
        else:
            assert torch.equal(a, b), name


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")


@pytest.mark.gpu
def test_physics_group_with_the_pattern_matches_its_plain_version():
    """Needs an NVIDIA GPU and nvcc: in float64, the physics' inverse group
    with the SPPT spectrum (one launch) against the plain chain, and the
    physics kernel fed that pattern against its plain version on the same
    tensors, within 1e-12."""
    _needs_card()
    params = dataclasses.replace(T_SPPT, fft_mode="matmul")
    gconsts, gstate, _ = make_demo_model(params, device="cuda")
    st = TE.broadcast_state(gstate, 4)
    spec = TSP.advance(gconsts.sppt, st["sppt_spec"],
                       next(TSP.draw_run_noise(gconsts, st["sppt_key"], 2, 1)))
    before = ck.launch_counts["fused_spec2grid"]
    args, kw = TD.physics_grid_inputs(gconsts, st, True, spec)
    assert ck.launch_counts["fused_spec2grid"] == before + 1
    want = torch.clamp(TK.spec2grid_plain(gconsts.sp, spec, 1, 1), -1.0, 1.0)
    assert rel_err(kw["sppt_pattern"].cpu().numpy(),
                   want.cpu().numpy()) <= 1e-12
    out = ck.grid_physics_cuda(gconsts, True, *args, **kw)
    ref = TD.grid_physics(gconsts, True, *args, **kw)
    for a, b in zip(out[:4], ref[:4]):
        assert rel_err(a.cpu().numpy(), b.cpu().numpy()) <= 1e-12


@pytest.mark.gpu
def test_sppt_day_on_the_card_matches_the_cpu():
    """Needs an NVIDIA GPU and nvcc: a float64 SPPT day at B=4 on the card
    (the kernels) against the same day on the CPU (the plain versions), the
    same member keys: within 1e-9."""
    _needs_card()
    params = dataclasses.replace(T_SPPT, fft_mode="matmul")
    cconsts, cstate, cal = make_demo_model(params, device="cpu",
                                           grid_phi=True)
    gconsts, _ = TM.build_consts(params, device="cuda", grid_phi=True)
    ctx, _ = TM.build_step_ctx(dataclasses.replace(cal), 2, 36)
    cout = TE.make_run_steps_batched(cconsts, device="cpu")(
        TE.broadcast_state(cstate, 4), ctx)
    gin = {k: (tuple(a.cuda() for a in v) if isinstance(v, tuple)
               else v.cuda()) for k, v in cstate.items()}
    gout = TE.make_run_steps_batched(gconsts, device="cuda")(
        TE.broadcast_state(gin, 4), ctx)
    for name in PROGNOSTICS:
        assert rel_err(gout[name][0].cpu().numpy(),
                       cout[name][0].numpy()) <= 1e-9, name
    assert rel_err(gout["sppt_spec"].cpu().numpy(),
                   cout["sppt_spec"].numpy()) <= 1e-9
