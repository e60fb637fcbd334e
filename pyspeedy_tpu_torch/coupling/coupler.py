"""Land/sea coupler facade (reference: speedy.f90/coupler.f90).

The model step (models/model.py) calls these two entry points; they simply
sequence the land and sea exchanges like the reference's
initialize_coupler/couple_sea_land."""

from __future__ import annotations

from ..utils.profiling import span
from .land import couple_land_atm
from .sea import couple_sea_atm

__all__ = ["initialize_coupler", "couple_sea_land", "CLIMATOLOGY_PLANES",
           "ALIASES", "SHARED_PLANES", "STEP_COPIES"]

# What the exchange hands on, for a caller that holds the state in buffers of
# its own (parallel/ensemble.py::_BufferPlan):
# - the fields interpolated from the climatologies alone, the same for every
#   member: each comes back as one plane (the step expands it over the
#   members), and with `out` is written into the plane that out gives;
CLIMATOLOGY_PLANES = frozenset({"stlcl_obs", "snowdcl_obs", "soilwcl_obs",
                                "sstcl_ob", "sicecl_ob", "ticecl_ob"})
# - fields handed on as another field's tensor, by that field (read by the
#   exchange only before that field is written);
ALIASES = {"snow_depth": "snowdcl_obs", "soil_avail_water": "soilwcl_obs",
           "sice_om": "sicecl_ob", "tice_am": "tice_om"}
# - sice_am, the last exchange's sice_om: the slab ocean reads it after the
#   new sicecl_ob is written, so it is handed on, a plane, at the end. The
#   one field a caller with its own buffers copies.
STEP_COPIES = frozenset({"sice_am"})
# The fields that come back as one plane for all members.
SHARED_PLANES = CLIMATOLOGY_PLANES | {"snow_depth", "soil_avail_water",
                                      "sice_om", "sice_am"}


def initialize_coupler(consts, state, tables):
    """Day-0 initialization of both coupled models (coupler.f90:12-32).
    The land/sea *constant* fields must already be in the state
    (land_model_init / sea_model_init). `tables`
    (interpolation.CouplerTables) holds the date's month rows and weights."""
    state = couple_land_atm(consts, state, True, tables)
    state = couple_sea_atm(consts, state, True, tables)
    return state


def couple_sea_land(consts, state, tables, out=None):
    """Per-step flux exchange with both coupled models (coupler.f90:35-48;
    called every step from speedy.f90:72), at the date whose month rows and
    weights `tables` holds on the device. With `out` (the state's own
    tensors by field) the member-batched fields that the slab models
    advance are written into them, and the CLIMATOLOGY_PLANES into the
    planes of those that out gives as one plane expanded over the members
    (interpolation.shared_plane; new planes otherwise). Under the span
    `coupler`."""
    with span("coupler"):
        state = couple_land_atm(consts, state, False, tables, out)
        return couple_sea_atm(consts, state, False, tables, out)
