"""Land/sea coupler facade (reference: speedy.f90/coupler.f90).

The model step (models/model.py) calls these two entry points; they simply
sequence the land and sea exchanges like the reference's
initialize_coupler/couple_sea_land."""

from __future__ import annotations

from .land import couple_land_atm
from .sea import couple_sea_atm

__all__ = ["initialize_coupler", "couple_sea_land"]


def initialize_coupler(consts, state, tables):
    """Day-0 initialization of both coupled models (coupler.f90:12-32).
    The land/sea *constant* fields must already be in the state
    (land_model_init / sea_model_init). `tables`
    (interpolation.CouplerTables) holds the date's month rows and weights."""
    state = couple_land_atm(consts, state, True, tables)
    state = couple_sea_atm(consts, state, True, tables)
    return state


def couple_sea_land(consts, state, tables):
    """Per-step flux exchange with both coupled models (coupler.f90:35-48;
    called every step from speedy.f90:72), at the date whose month rows and
    weights `tables` holds on the device."""
    state = couple_land_atm(consts, state, False, tables)
    state = couple_sea_atm(consts, state, False, tables)
    return state
