"""Initial parameter values: the polymorphic --indF / --freq arguments.

Replicates init_output (reference: parse_args.cpp:229-419):

 --indF accepts "r" (random), an existing file of "F<sep>alpha" lines, or a
 literal "F-alpha"/"F,alpha" pair; values clamp to [1e-6, 1-1e-6].
 --freq accepts "r" (random), "e" (HWE estimate via est_maf with F=0), an
 existing file of one freq per line, or a literal; clamps to [0.01, 0.49].

Random draws come from a seeded GSL-taus generator in the reference's
consumption order -- (F_i, alpha_i) pairs first, then one freq per site --
so seeded runs match the reference bit-for-bit (parse_args.cpp:232-233,
251-253, 309-310).
"""

import os
import re

import numpy as np

from ..utils.constants import (
    ALPHA_RNG_MAX,
    ALPHA_RNG_MIN,
    FREQ_RNG_MAX,
    FREQ_RNG_MIN,
    INDF_RNG_MAX,
    INDF_RNG_MIN,
)
from .gsl_rng import GslTaus
from .readers import _open_maybe_gz

_SEP_INDF_FILE = re.compile(r"[ ,\-\t]+")


def _atof(s):
    """C atof: leading-numeric prefix, 0.0 on garbage."""
    m = re.match(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?)", s)
    return float(m.group(0)) if m else 0.0


def init_indF_alpha(spec, n_ind, rng: GslTaus):
    """Initial (indF [N], alpha [N]) from an --indF spec."""
    indF = np.zeros(n_ind)
    alpha = np.zeros(n_ind)
    if spec == "r":
        for i in range(n_ind):
            indF[i] = INDF_RNG_MIN + rng.uniform() * (INDF_RNG_MAX - INDF_RNG_MIN)
            alpha[i] = ALPHA_RNG_MIN + rng.uniform() * (ALPHA_RNG_MAX - ALPHA_RNG_MIN)
        return indF, alpha
    if os.path.isfile(spec):
        i = 0
        with _open_maybe_gz(spec) as fh:
            for line in fh:
                line = line.rstrip("\r\n")
                if not line:
                    continue
                t = [x for x in _SEP_INDF_FILE.split(line) if x != ""]
                vals = []
                for x in t:
                    try:
                        vals.append(float(x))
                    except ValueError:
                        pass
                # >=: a file with more lines than n_ind is an error here
                # (the reference's `i > pars->n_ind` check at
                # parse_args.cpp:267 is off by one and silently overflows)
                if i >= n_ind or len(vals) != 2:
                    raise ValueError("wrong INDF file format!")
                indF[i] = min(max(vals[0], INDF_RNG_MIN), INDF_RNG_MAX)
                alpha[i] = min(max(vals[1], ALPHA_RNG_MIN), ALPHA_RNG_MAX)
                i += 1
        return indF, alpha
    # literal "F-alpha" / "F,alpha"
    t = [x for x in re.split(r"[,\-]+", spec) if x != ""]
    if len(t) != 2:
        raise ValueError("wrong INDF parameters format!")
    indF[:] = min(max(float(t[0]), INDF_RNG_MIN), INDF_RNG_MAX)
    alpha[:] = min(max(float(t[1]), ALPHA_RNG_MIN), ALPHA_RNG_MAX)
    return indF, alpha


def init_freq(spec, n_sites, rng: GslTaus, gl=None, freq_est=1):
    """Initial freq [S] from a --freq spec.

    gl ([S, N, 3] log, needed for spec == "e") feeds the HWE est_maf
    estimate with F = 0 (parse_args.cpp:312-318). Under freq_est == 2
    the reference instead derives sites >= 2 from pair-EM haplotype
    frequencies (parse_args.cpp:316-321) -- here via the CORRECTED
    two-site EM (ops/haplo.ld_init_freq; the reference's is NaN-broken).
    """
    freq = np.full(n_sites, FREQ_RNG_MIN)
    if spec == "r":
        for s in range(n_sites):
            freq[s] = FREQ_RNG_MIN + rng.uniform() * (FREQ_RNG_MAX - FREQ_RNG_MIN)
        return freq
    if spec == "e":
        raise NotImplementedError(
            "freq init 'e' needs est_maf "
            "(ROADMAP queue 1: 'freq_est 1' slice)"
        )
    if os.path.isfile(spec):
        s = 0
        with _open_maybe_gz(spec) as fh:
            for line in fh:
                line = line.rstrip("\r\n")
                if not line:
                    continue
                t = [x for x in _SEP_INDF_FILE.split(line) if x != ""]
                vals = []
                for x in t:
                    try:
                        vals.append(float(x))
                    except ValueError:
                        pass
                if not vals:
                    continue  # header
                if s >= n_sites or len(vals) != 1:
                    raise ValueError("wrong FREQ file format!")
                freq[s] = min(max(vals[0], FREQ_RNG_MIN), FREQ_RNG_MAX)
                s += 1
        return freq
    freq[:] = min(max(_atof(spec), FREQ_RNG_MIN), FREQ_RNG_MAX)
    return freq
