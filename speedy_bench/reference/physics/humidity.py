"""Humidity conversions (reference: speedy.f90/humidity.f90).

q is in g/kg throughout the physics; pressure is normalized by 1000 hPa.
Level-stacked fields carry the level axis third from the end: (..., kx, il,
ix), with or without a leading member axis.
"""

from __future__ import annotations

import torch

__all__ = ["get_qsat", "spec_hum_to_rel_hum", "rel_hum_to_spec_hum"]

_E0 = 6.108e-3
_C1 = 17.269
_C2 = 21.875
_T0 = 273.16
_T1 = 35.86
_T2 = 7.66


def get_qsat(ta: torch.Tensor, ps: torch.Tensor, sig) -> torch.Tensor:
    """Saturation specific humidity [g/kg] (humidity.f90:44-78).

    ta: temperature [K]; ps: normalized pressure p/1000hPa; sig: sigma level,
    a Python float (<= 0 means use the constant pressure ps[..., 0, 0], as the
    reference does for its reference-profile call) or a tensor of sigma
    levels that broadcasts against ps.
    """
    e = torch.where(
        ta >= _T0,
        _E0 * torch.exp(_C1 * (ta - _T0) / (ta - _T1)),
        _E0 * torch.exp(_C2 * (ta - _T0) / (ta - _T2)),
    )
    if not isinstance(sig, torch.Tensor) and float(sig) <= 0.0:
        p = ps[..., 0:1, 0:1]
    else:
        p = sig * ps
    return 622.0 * e / (p - 0.378 * e)


def spec_hum_to_rel_hum(ta, ps, sig, qa):
    """Returns (rh, qsat) (humidity.f90:17-27)."""
    qsat = get_qsat(ta, ps, sig)
    return qa / qsat, qsat


def rel_hum_to_spec_hum(ta, ps, sig, rh):
    """Returns (qa, qsat) (humidity.f90:31-41)."""
    qsat = get_qsat(ta, ps, sig)
    return rh * qsat, qsat
