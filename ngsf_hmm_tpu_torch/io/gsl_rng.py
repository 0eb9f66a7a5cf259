"""GSL 'taus' RNG parity layer.

The reference seeds a GSL Tausworthe (taus88, L'Ecuyer 1996) generator for
the random initial values of indF/alpha/freq (reference:
parse_args.cpp:232-233, 251-253, 309-310). Replicating its exact draw
sequence makes seeded runs bit-comparable to the reference binary.

This is an independent implementation of the published taus88 algorithm;
draws are produced in the same order the reference consumes them:
first (F_i, alpha_i) pairs for every individual, then one freq per site.
"""

import numpy as np

_MASK = 0xFFFFFFFF


class GslTaus:
    """taus88 generator matching GSL's gsl_rng_taus seed/draw sequence."""

    def __init__(self, seed: int):
        s = seed & _MASK
        if s == 0:
            s = 1
        lcg = lambda n: (69069 * n) & _MASK
        self.s1 = lcg(s)
        if self.s1 < 2:
            self.s1 += 2
        self.s2 = lcg(self.s1)
        if self.s2 < 8:
            self.s2 += 8
        self.s3 = lcg(self.s2)
        if self.s3 < 16:
            self.s3 += 16
        for _ in range(6):  # GSL "warm up"
            self._get()

    def _get(self) -> int:
        s1, s2, s3 = self.s1, self.s2, self.s3
        self.s1 = (((s1 & 4294967294) << 12) & _MASK) ^ ((((s1 << 13) & _MASK) ^ s1) >> 19)
        self.s2 = (((s2 & 4294967288) << 4) & _MASK) ^ ((((s2 << 2) & _MASK) ^ s2) >> 25)
        self.s3 = (((s3 & 4294967280) << 17) & _MASK) ^ ((((s3 << 3) & _MASK) ^ s3) >> 11)
        return self.s1 ^ self.s2 ^ self.s3

    def uniform(self) -> float:
        """One double in [0, 1), identical to gsl_rng_uniform(taus)."""
        return self._get() / 4294967296.0

    def uniforms(self, n: int) -> np.ndarray:
        """n sequential uniform draws as float64.

        The recurrence is inherently sequential (a Python loop).
        """
        out = np.empty(n, dtype=np.float64)
        get = self._get
        for i in range(n):
            out[i] = get() / 4294967296.0
        return out
