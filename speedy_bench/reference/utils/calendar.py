"""Model calendar replicating the reference's 365-day calendar with its
leap-day patch (reference: speedy.f90/model_control.f90).

The reference advances dates by int(24*60/nsteps) minutes per step on a
365-day calendar, but inserts Feb 29 in years divisible by 4
(model_control.f90:136-143) while the forcing-phase functions (tmonth, tyear)
keep using the 365-day month tables. Both behaviors are replicated.

One deliberate fix over the reference: the step is applied in exact seconds
(86400 // nsteps) rather than truncated whole minutes, so presets whose step
is not a whole number of minutes (e.g. T47L8's 1600 s) keep the calendar in
phase with the dynamics. For the reference's own nsteps=36 (2400 s = 40 min)
the two schemes are identical. ModelParams validates 86400 % nsteps == 0.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime

__all__ = ["ModelCalendar"]

_NCAL = 365
_NDAYCAL = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
_CUMDAYS = [0]
for _d in _NDAYCAL[:-1]:
    _CUMDAYS.append(_CUMDAYS[-1] + _d)


@dataclasses.dataclass
class ModelCalendar:
    """Mirror of ControlParams_t's date state (model_control.f90:38-49)."""

    year: int
    month: int
    day: int
    hour: int
    minute: int
    month_idx: int = 1
    nsteps: int = 36
    second: int = 0

    @classmethod
    def from_datetime(cls, dt: datetime, nsteps: int = 36) -> "ModelCalendar":
        return cls(dt.year, dt.month, dt.day, dt.hour, dt.minute,
                   month_idx=1, nsteps=nsteps, second=dt.second)

    def to_datetime(self) -> datetime:
        return datetime(self.year, self.month, self.day, self.hour,
                        self.minute, self.second)

    @property
    def imont1(self) -> int:
        return self.month

    @property
    def tmonth(self) -> float:
        return (self.day - 0.5) / float(_NDAYCAL[self.month - 1])

    @property
    def tyear(self) -> float:
        return (_CUMDAYS[self.month - 1] + self.day - 0.5) / float(_NCAL)

    def advance(self) -> None:
        """One step of 86400/nsteps seconds (model_control.f90:114-160,
        exact-seconds fix — see module docstring)."""
        total = self.second + 86400 // self.nsteps
        self.second = total % 60
        self.minute += total // 60
        if self.minute >= 60:
            self.hour += self.minute // 60
            self.minute = self.minute % 60
        if self.hour >= 24:
            self.hour = self.hour % 24
            self.day += 1
        if self.year % 4 == 0 and self.month == 2:
            if self.day > 29:
                self.day = 1
                self.month += 1
                self.month_idx += 1
        else:
            if self.day > _NDAYCAL[self.month - 1]:
                self.day = 1
                self.month += 1
                self.month_idx += 1
        if self.month > 12:
            self.month = 1
            self.year += 1
