"""Error code -> message mapping (reference: pyspeedy/error_codes.py,
speedy.f90/error_codes.f90)."""

from collections import defaultdict

SUCCESS = 0
E_STATE_NOT_INITIALIZED = -1
E_DIAGNOSTICS_OUTSIDE_RANGE = -2

ERROR_CODES = defaultdict(lambda: "Unknown error.")
ERROR_CODES[E_STATE_NOT_INITIALIZED] = (
    "The model state was not initialized.")
ERROR_CODES[E_DIAGNOSTICS_OUTSIDE_RANGE] = (
    "Model variables out of accepted range."
)
