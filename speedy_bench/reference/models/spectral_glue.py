"""The spectral side of a leapfrog step as one function.

Everything between the direct transforms and the new prognostic state:
spectral flux combination (tendencies.f90:244-268), linear reference-profile
tendencies (:283-352), the semi-implicit correction (implicit.f90:234-289),
horizontal diffusion + stratospheric drag (time_stepping.f90:78-122) and the
Robert-Williams leapfrog (:124-188). It is pointwise/shift/level-contraction
algebra on (B, 2, kx, mx, nx) real-pair tensors.

Always the plain PyTorch version here (:func:`spectral_update_plain`).
"""

from __future__ import annotations

from ..ops import glue as GK
from .implicit import implicit_terms
from .tendencies import combine_specs, spectral_linear_tendencies
from .timestep import diffusion_and_drag, step_field

__all__ = ["spectral_update", "spectral_update_plain", "update_inputs",
           "apply_spectral_update", "PAIR_FIELDS"]


def spectral_update(consts, j1: int, dt: float, eps: float, specs, psdt,
                    vor0, vor1, div0, div1, t0, t1, ps0, ps1,
                    trf0, trf1, phi, tcorh, qcorh, out=None):
    """specs: direct-transform outputs (list); state pairs at both time
    levels with tracers FLAT (B, 2, ntr*kx, mx, nx); tcorh/qcorh
    (B, 2, mx, nx). Returns the ten new state tensors
    (ps, vor, div, t, trf) x (lev1, lev2), stored into `out` (ten dense
    tensors, which may be the state pairs themselves) when given."""
    return GK.spectral_update(spectral_update_plain, consts, j1, dt, eps,
                              specs, psdt, vor0, vor1, div0, div1, t0, t1,
                              ps0, ps1, trf0, trf1, phi, tcorh, qcorh,
                              out=out)


def spectral_update_plain(consts, j1: int, dt: float, eps: float, specs,
                          psdt, vor0, vor1, div0, div1, t0, t1, ps0, ps1,
                          trf0, trf1, phi, tcorh, qcorh):
    """The plain PyTorch version of the spectral update: same arguments and
    results as spectral_update."""
    params = consts.params
    sp = consts.sp

    vordt, divdt, tdt, trdt = combine_specs(consts, specs, params.ntr,
                                            params.kx)

    # --- linear spectral tendencies + implicit (tendencies.f90:24-37) ---
    divdt, tdt, psdt = spectral_linear_tendencies(
        consts, div0, ps0, phi, divdt, tdt, psdt)
    divdt, tdt, psdt = implicit_terms(consts.implicit, divdt, tdt, psdt)

    vordt, divdt, tdt, trdt = diffusion_and_drag(
        consts, vor0, div0, t0, trf0, tcorh, qcorh, vordt, divdt, tdt, trdt)

    # --- leapfrog + Robert-Williams filter (time_stepping.f90:124-144) ---
    lf = lambda f0_, f1_, fdt_: step_field(params, sp, j1, dt, eps,
                                           (f0_, f1_), fdt_)
    ps0n, ps1n = lf(ps0, ps1, psdt)
    vor0n, vor1n = lf(vor0, vor1, vordt)
    div0n, div1n = lf(div0, div1, divdt)
    t0n, t1n = lf(t0, t1, tdt)
    trf0n, trf1n = lf(trf0, trf1, trdt)
    return (ps0n, ps1n, vor0n, vor1n, div0n, div1n, t0n, t1n, trf0n, trf1n)


def update_inputs(state, psdt) -> tuple:
    """The state arguments of spectral_update after `specs`, from the
    member-batched state dict: psdt, the prognostic pairs at both time levels
    (tracers flattened to (B, 2, ntr*kx, mx, nx), a view), phi, tcorh and
    qcorh."""
    tr0, tr1 = state["tr"]
    flat = lambda a: a.flatten(2, 3)
    return (psdt,
            state["vor"][0], state["vor"][1],
            state["div"][0], state["div"][1],
            state["t"][0], state["t"][1],
            state["ps"][0], state["ps"][1],
            flat(tr0), flat(tr1),
            state["phi"], state["tcorh"], state["qcorh"])


PAIR_FIELDS = ("ps", "vor", "div", "t", "tr")


def apply_spectral_update(consts, state, specs, psdt, j1: int, dt: float,
                          out=None):
    """Run spectral_update over the member-batched state dict. With `out`
    (a dict holding a dense pair of tensors for each of PAIR_FIELDS, the
    batched runner's buffers on its graph path) the new pairs are stored
    into those tensors, and the state comes back holding them."""
    params = consts.params
    eps = 0.0 if j1 == 1 else params.rob
    ntr, kx = params.ntr, params.kx
    dst = None
    if out is not None:
        dst = [a.flatten(2, 3) if name == "tr" else a
               for name in PAIR_FIELDS for a in out[name]]

    outs = spectral_update(consts, j1, dt, eps, list(specs),
                           *update_inputs(state, psdt), out=dst)

    state = dict(state)
    if out is not None:
        state.update((name, out[name]) for name in PAIR_FIELDS)
        return state
    (ps0, ps1, vor0, vor1, div0, div1, t0, t1, trf0, trf1) = outs
    unflat = lambda a: a.unflatten(2, (ntr, kx))
    state["ps"] = (ps0, ps1)
    state["vor"] = (vor0, vor1)
    state["div"] = (div0, div1)
    state["t"] = (t0, t1)
    state["tr"] = (unflat(trf0), unflat(trf1))
    return state
