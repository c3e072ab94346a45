# Copied from msm_tpu/constants.py, which is JAX-free; keep the two in step.
"""Physical constants for the Multi-Stream Method engine.

Units across the codebase are kpc, M_sun, Myr, matching the reference
(`common/src/constants.rs:1-9`).
"""

import math

# Poisson constant: 4 * pi * G in kpc^3 / (M_sun Myr^2).
# Reference: common/src/constants.rs:2 (POIS_CONST = 4 pi * 4.49e-12).
POIS_CONST: float = 4.0 * math.pi * 4.49e-12

# Reduced Planck constant in M_sun kpc^2 / Myr.
# Reference: common/src/constants.rs:5.
HBAR: float = 1.757e-90

# Converts little h (H0 in units of 100 km/s/Mpc) to H0 in 1/Myr.
# Reference: common/src/constants.rs:9.
LITTLE_H_TO_BIG_H: float = 1.022e-4
