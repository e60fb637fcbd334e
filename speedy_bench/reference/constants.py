"""Physical constants (reference: speedy.f90/physical_constants.f90:16-47,
mod_radcon.f90:11-16)."""

REARTH = 6.371e6        # Earth radius [m]
OMEGA = 7.292e-5        # Earth rotation rate [rad/s]
GRAV = 9.81             # gravitational acceleration [m/s^2]

P0 = 1.0e5              # reference pressure [Pa]
CP = 1004.0             # specific heat of dry air [J/K/kg]
AKAP = 2.0 / 7.0        # R/cp for dry air
RGAS = AKAP * CP        # dry-air gas constant [J/K/kg]
ALHC = 2501.0           # latent heat of condensation [J/g] (q is in g/kg)
ALHS = 2801.0           # latent heat of sublimation [J/g]
SBC = 5.67e-8           # Stefan-Boltzmann constant

GAMMA = 6.0             # reference lapse rate [K/km]
HSCALE = 7.5            # pressure scale height [km]
HSHUM = 2.5             # humidity scale height [km]
REFRH1 = 0.7            # reference near-surface relative humidity

THD = 2.4               # del^8 diffusion damping time, T and vor [h]
THDD = 2.4              # del^8 diffusion damping time, divergence [h]
THDS = 12.0             # stratospheric del^2 diffusion damping time [h]
TDRS = 24.0 * 30.0      # stratospheric zonal-mean wind drag time [h]

# Radiation / surface constants (mod_radcon.f90)
ALBSEA = 0.07           # open-sea albedo
ALBICE = 0.60           # sea-ice albedo (ice fraction = 1)
ALBSN = 0.60            # snow albedo (snow cover = 1)
EPSLW = 0.05            # fraction of blackbody spectrum in the PBL "black" band
EMISFC = 0.98           # longwave surface emissivity
