"""Physical constants.

Values follow the FV3GFS/FMS convention so prognostic fields are directly
comparable with the reference model (cf. reference
external/vcm/vcm/calc/thermo/constants.py which documents the same values
"as in FV3GFS model").
"""

PI = 3.14159265358979323846

# Earth
RADIUS = 6.3712e6  # m, Earth radius
GRAV = 9.80665  # m/s^2
OMEGA = 7.2921e-5  # 1/s, Earth rotation rate

# Dry air / water vapor thermodynamics
RDGAS = 287.05  # J/kg/K
RVGAS = 461.5  # J/kg/K
CP_AIR = 1004.0  # J/kg/K, specific heat at constant pressure
CV_AIR = CP_AIR - RDGAS
KAPPA = RDGAS / CP_AIR
ZVIR = RVGAS / RDGAS - 1.0

# Water
LATENT_HEAT_VAPORIZATION = 2.5e6  # J/kg at 0 C
LATENT_HEAT_FUSION = 3.3358e5  # J/kg
FREEZING_TEMPERATURE = 273.15  # K
DENSITY_WATER = 997.0  # kg/m^3

# Reference pressures
REFERENCE_SURFACE_PRESSURE = 100000.0  # Pa
DEFAULT_TOA_PRESSURE = 300.0  # Pa (79-level FV3GFS default model top)

SEC_PER_DAY = 86400.0
KG_M2S_TO_MM_DAY = (1e3 * SEC_PER_DAY) / DENSITY_WATER
KG_M2_TO_MM = 1000.0 / DENSITY_WATER
