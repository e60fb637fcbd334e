"""Simplified Tiedtke mass-flux convection (reference:
speedy.f90/convection.f90).

The reference's per-column downward loop with a data-dependent cloud top
(convection.f90:110-143) processes the levels below the cloud top, a suffix
of the level axis, so the sequential flux accumulation is written as suffix
sums along the levels and the frozen-at-exit values at the cloud top as
one-hot selections at itop: level-parallel elementwise tensor math, the JAX
package's formulation, kept so that float64 results agree with it to
rounding. (The CUDA physics kernel runs the same scheme as the column loop
it is.) Fields are (..., kx, il, ix) stacks and (..., il, ix) planes. Level
indices in the integer fields (itop) keep the reference's 1-based
convention: itop = kx+1 means "no convection".
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as pc
from ._levels import LEV, col, lev, shift_up

__all__ = ["get_convection_tendencies", "diagnose_convection",
           "entrainment_profile", "PSMIN", "TRCNV", "RHBL", "RHIL", "ENTMAX",
           "SMF", "FQMAX"]

PSMIN = 0.8    # minimum normalized surface pressure for convection
TRCNV = 6.0    # relaxation time [h]
RHBL = 0.9     # boundary-layer RH threshold
RHIL = 0.7     # intermediate-layer RH threshold (secondary flux)
ENTMAX = 0.5   # maximum entrainment fraction
SMF = 0.8      # secondary/primary cloud-base mass-flux ratio
FQMAX = 5.0    # cap of the humidity-excess ratio in the cloud-base mass flux


def _rev_cumsum(x):
    """Suffix sums along the level axis, out[k] = sum_{j >= k} x[j], by
    log-depth shift-adds (the JAX package's order of additions)."""
    n = x.shape[LEV]
    shift = 1
    while shift < n:
        x = x + shift_up(x, shift)
        shift *= 2
    return x


def entrainment_profile(geom) -> np.ndarray:
    """Entrainment fractions per level (convection.f90:62-70), 1-based
    k = 2..kx-1; (kx,) numpy in the geometry's dtype."""
    fsg = np.asarray(geom.fsg)
    kx = fsg.shape[0]
    entr = np.zeros(kx, dtype=fsg.dtype)
    entr_raw = np.maximum(0.0, fsg[1:kx - 1] - 0.5) ** 2
    entr[1:kx - 1] = ENTMAX * entr_raw / entr_raw.sum()
    return entr


def diagnose_convection(geom, psa, se, qa, qsat):
    """Conditional-instability / RH-threshold diagnosis
    (convection.f90:170-253). Returns (itop [1-based int32], qdif).

    The reference's descending "last hit wins" sweep selects the smallest
    hitting level: a masked min along the levels."""
    kx = se.shape[LEV]
    nl1 = kx - 1
    nlp = kx + 1
    wvi = np.asarray(geom.wvi)

    # Saturation moist static energy
    mss = se + pc.ALHC * qsat

    rlhc = 1.0 / pc.ALHC
    mse0 = lev(se, kx - 1) + pc.ALHC * lev(qa, kx - 1)
    mse1 = torch.minimum(mse0, lev(se, nl1 - 1) + pc.ALHC * lev(qa, nl1 - 1))
    mss0 = torch.maximum(mse0, lev(mss, kx - 1))

    # Sweep levels 1-based k = 3 .. kx-3 (convection.f90:228-244): half-level
    # saturation MSE, then the smallest k whose threshold is exceeded.
    lo, hi = 2, kx - 3
    big = float(kx)
    if hi <= lo:   # kx = 5: the sweep is empty, convection never deep
        ktop1 = torch.full_like(psa, big)
        ktop2 = torch.full_like(psa, big)
        msthr = torch.zeros_like(psa)
    else:
        w1 = col(wvi[lo:hi, 1], se)
        mss_lo = mss.narrow(LEV, lo, hi - lo)
        mss2 = mss_lo + w1 * (mss.narrow(LEV, lo + 1, hi - lo) - mss_lo)
        ks = col(np.arange(lo, hi) + 1, se)

        hit1 = mss0.unsqueeze(LEV) > mss2
        ktop1 = torch.where(hit1, ks, big).amin(dim=LEV)
        hit2 = mse1.unsqueeze(LEV) > mss2
        ktop2 = torch.where(hit2, ks, big).amin(dim=LEV)
        # msthr = mss2 at the selected (smallest) hitting level
        sel2 = ks == ktop2.unsqueeze(LEV)
        msthr = torch.where(sel2 & hit2, mss2, 0.0).sum(dim=LEV)

    qthr0 = RHBL * lev(qsat, kx - 1)
    qthr1 = RHBL * lev(qsat, nl1 - 1)
    lqthr = (lev(qa, kx - 1) > qthr0) & (lev(qa, nl1 - 1) > qthr1)

    candidate = (psa > PSMIN) & (ktop1 < kx)
    deep = candidate & (ktop2 < kx)
    shallow = candidate & (ktop2 >= kx) & lqthr

    itop = torch.where(deep | shallow, ktop1, float(nlp)).to(torch.int32)
    zero = torch.zeros_like(psa)
    qdif = torch.where(
        deep,
        torch.maximum(lev(qa, kx - 1) - qthr0, (mse0 - msthr) * rlhc),
        torch.where(shallow, lev(qa, kx - 1) - qthr0, zero))
    return itop, qdif


def get_convection_tendencies(geom, psa, se, qa, qsat):
    """Convective fluxes of dry static energy and moisture
    (convection.f90:27-158).

    Returns (itop, cbmf, precnv, dfse, dfqa); dfse/dfqa are the *fluxes* to
    be scaled by rps*grdscp/grdsig in the physics driver (physics.f90:127-130).
    """
    kx = se.shape[LEV]
    wvi = np.asarray(geom.wvi)
    fm0 = pc.P0 * float(geom.dhs[kx - 1]) / (pc.GRAV * TRCNV * 3600.0)
    rdps = 2.0 / (1.0 - PSMIN)
    entr = col(entrainment_profile(geom), se)

    itop, qdif = diagnose_convection(geom, psa, se, qa, qsat)
    active = itop <= kx
    zero = torch.zeros_like(psa)
    up = lambda x: x.unsqueeze(LEV)

    # --- cloud-base (boundary) layer, k = kx (convection.f90:80-108) ---
    k0 = kx - 1
    se_k0, se_k1 = lev(se, k0), lev(se, k0 - 1)
    qa_k0, qa_k1 = lev(qa, k0), lev(qa, k0 - 1)
    qmax = torch.maximum(1.01 * qa_k0, lev(qsat, k0))
    w_b = float(wvi[k0 - 1, 1])
    sb_b = se_k1 + w_b * (se_k0 - se_k1)
    qb_b = torch.minimum(qa_k1 + w_b * (qa_k0 - qa_k1), qa_k0)
    fpsa = psa * torch.clamp((psa - PSMIN) * rdps, max=1.0)
    fmass0 = fm0 * fpsa * torch.clamp(qdif / (qmax - qb_b), max=FQMAX)
    cbmf = torch.where(active, fmass0, zero)

    fus_bb = torch.where(active, cbmf * se_k0, zero)
    fuq_bb = torch.where(active, cbmf * qmax, zero)
    fds_bb = torch.where(active, cbmf * sb_b, zero)
    fdq_bb = torch.where(active, cbmf * qb_b, zero)

    # --- intermediate layers, 1-based k = kx-1 .. 3 (convection.f90:110-143)
    # m = active & (k > itop): true on a contiguous suffix of the levels, so
    # the sequential updates are bottom-up suffix sums ("after" = the value
    # just after this level's update; "before" = the level below's "after",
    # with the boundary layer at the bottom).
    karr = torch.arange(1, kx + 1, dtype=torch.int32,
                        device=se.device).reshape(-1, 1, 1)   # 1-based
    interm = (karr >= 3) & (karr <= kx - 1)
    m = up(active) & (karr > up(itop)) & interm

    enmass = torch.where(m, entr * up(psa) * up(cbmf), 0.0)
    fmass_after = up(cbmf) + _rev_cumsum(enmass)
    fus_after_c = up(fus_bb) + _rev_cumsum(enmass * se)
    fuq_after_c = up(fuq_bb) + _rev_cumsum(enmass * qa)

    # Half-level downdraft values per level (sb[k] uses se[k-1], se[k]).
    w1 = col(wvi[:-1, 1], se)

    def half_below(x):
        top = x.narrow(LEV, 0, kx - 1)
        return torch.cat([torch.zeros_like(x.narrow(LEV, 0, 1)),
                          top + w1 * (x.narrow(LEV, 1, kx - 1) - top)],
                         dim=LEV)

    sb = half_below(se)
    qb = half_below(qa)

    fds_after = torch.where(m, fmass_after * sb, 0.0)
    fdq_after = torch.where(m, fmass_after * qb, 0.0)

    def before(after, bottom):
        """The value level k sees before its update = level k+1's "after";
        the last intermediate level (k = kx-2) sees the boundary-layer
        value, and row kx-1 (the boundary layer itself, never masked) is
        filled with `bottom` so one-hot selections at itop = kx-1 pick the
        loop-never-fired value."""
        return torch.cat([after.narrow(LEV, 1, kx - 2), up(bottom),
                          up(bottom)], dim=LEV)

    fus_bef = before(fus_after_c, fus_bb)
    fuq_bef = before(fuq_after_c, fuq_bb)
    fds_bef = before(fds_after, fds_bb)
    fdq_bef = before(fdq_after, fdq_bb)

    dfse = torch.where(
        m, (fus_bef - fds_bef) + (fds_after - fus_after_c), 0.0)
    dfqa = torch.where(
        m, (fuq_bef - fdq_bef) + (fdq_after - fuq_after_c), 0.0)

    # Secondary moisture flux (convection.f90:134-141)
    delq = RHIL * qsat - qa
    fsq = SMF * up(cbmf) * delq
    msec = m & (delq > 0.0)
    sec = torch.where(msec, fsq, 0.0)
    dfqa = dfqa + sec

    # --- top layer: condensation and detrainment (convection.f90:145-155) ---
    # Final (frozen-at-exit) fluxes = the topmost "after" values.
    fmass_fin = lev(fmass_after, 0)
    fus_fin = lev(fus_after_c, 0)
    fuq_fin = lev(fuq_after_c, 0)
    # fds/fdq froze at their last update (level itop+1); seen from the top
    # layer's row (karr == itop) that is its before-value.
    at_top = karr == up(itop)
    fds_fin = torch.where(at_top, fds_bef, 0.0).sum(dim=LEV)
    fdq_fin = torch.where(at_top, fdq_bef, 0.0).sum(dim=LEV)

    m_top = up(active) & at_top & interm
    qs_top = qsat.narrow(LEV, 0, kx - 1)
    qsatb = torch.cat(
        [qs_top + w1 * (qsat.narrow(LEV, 1, kx - 1) - qs_top),
         torch.zeros_like(qsat.narrow(LEV, 0, 1))], dim=LEV)
    pr = torch.clamp(up(fuq_fin) - up(fmass_fin) * qsatb, min=0.0)
    precnv = torch.where(m_top, pr, 0.0).sum(dim=LEV)
    dfse = dfse + torch.where(
        m_top, up(fus_fin - fds_fin) + pc.ALHC * pr, 0.0)
    dfqa = dfqa + torch.where(m_top, up(fuq_fin - fdq_fin) - pr, 0.0)

    # Boundary layer row (k = kx)
    bot = torch.zeros((kx, 1, 1), dtype=se.dtype, device=se.device)
    bot[kx - 1] = 1.0
    sec_total = sec.sum(dim=LEV)
    dfse = dfse + bot * up(fds_bb - fus_bb)
    dfqa = dfqa + bot * up((fdq_bb - fuq_bb) - sec_total)

    return itop, cbmf, precnv, dfse, dfqa
