"""Numeric constants shared across the engine.

These mirror the reference's fixed constants (reference:
shared/gen_func.hpp:14-18) so that compat-mode numerics agree:

- ``N_GENO = 3``       -- diallelic genotypes {AA, Aa, aa}
- ``N_STATES = 2``     -- HMM states {non-IBD, IBD}
- ``BIG = 1e15``       -- the reference's finite stand-in for infinity
                          (``INF``); ``-BIG`` is used instead of ``-inf``
                          in log space to avoid NaNs from ``0 * inf``.
- ``EPSILON = 1e-5``   -- convergence / snapping tolerance
- ``ITER_MAX = 100``   -- inner fixed-point iteration cap
"""

N_GENO = 3
N_STATES = 2
BIG = 1e15
EPSILON = 1e-5
ITER_MAX = 100

# Default bounds for the per-individual (F, alpha) M-step
# (reference: EM.cpp:425-427).
F_MIN = 1.0 / BIG
F_MAX = 1.0 - 1.0 / BIG
ALPHA_MIN = 1.0 / BIG
ALPHA_MAX = 10.0

# Initialisation clamps (reference: parse_args.cpp:239-242,296-297).
INDF_RNG_MIN = 0.000001
INDF_RNG_MAX = 1.0 - INDF_RNG_MIN
ALPHA_RNG_MIN = 0.000001
ALPHA_RNG_MAX = 1.0 - ALPHA_RNG_MIN
FREQ_RNG_MIN = 0.01
FREQ_RNG_MAX = 0.5 - FREQ_RNG_MIN

VERSION = "0.1.0"
