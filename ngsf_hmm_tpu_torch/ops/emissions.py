"""Emission probabilities: P(GLs | state) under HWE-with-inbreeding priors.

For state k in {0 = non-IBD, 1 = IBD}, the emission at a site with minor
allele frequency ``maf`` is

    e_k = log sum_g GL[g] * P(g | maf, F=k)

(reference: shared/HMM.cpp:144-154), computed for the whole [S, N, 2]
tensor in one elementwise pass.
"""

import torch

from ..utils.constants import BIG
from .logsum import logsum3


def log_hwe_by_state(maf):
    """Log genotype priors for both states, [..., 2, 3], from maf [...].

    State 0: HWE (F=0) -> [(1-p)^2, 2p(1-p), p^2]
    State 1: full IBD (F=1) -> [(1-p), 1/BIG, p]  (het floored; see
    calc_HWE's F==1 special case, gen_func.cpp:946-956).
    """
    p = maf
    one_m = 1.0 - p
    pq = one_m * p
    g0 = torch.stack([one_m * one_m, 2.0 * pq, p * p], dim=-1)
    g1 = torch.stack([one_m * one_m + pq, torch.ones_like(p), p * p + pq],
                     dim=-1)
    big = torch.full_like(g0, -BIG)
    lg0 = torch.log(g0)
    lg0 = torch.where(torch.isneginf(lg0), big, lg0)
    lg1 = torch.log(g1)
    lg1 = torch.where(torch.isneginf(lg1), big, lg1)
    lg1 = torch.stack([lg1[..., 0], big[..., 1], lg1[..., 2]], dim=-1)
    return torch.stack([lg0, lg1], dim=-2)


def calc_emission(gl, maf):
    """Log emissions [..., 2] for both states.

    gl:  [..., 3]  normalised log genotype likelihoods
    maf: broadcastable to gl[..., 0]
    """
    lpri = log_hwe_by_state(maf)  # [..., 2, 3]
    x = gl[..., None, :] + lpri
    return logsum3(x[..., 0], x[..., 1], x[..., 2])


def emission_probs_linear(gl_lin, maf):
    """Linear emissions [..., 2]: e_k = sum_g gl[g] * P(g | maf, F=k) for
    normalised linear-space genotype likelihoods gl_lin [..., 3]."""
    p = maf
    one_m = 1.0 - p
    pq = one_m * p
    het_floor = 1.0 / BIG
    e0 = (
        gl_lin[..., 0] * (one_m * one_m)
        + gl_lin[..., 1] * (2.0 * pq)
        + gl_lin[..., 2] * (p * p)
    )
    e1 = (
        gl_lin[..., 0] * (one_m * one_m + pq)
        + gl_lin[..., 1] * het_floor
        + gl_lin[..., 2] * (p * p + pq)
    )
    return torch.stack([e0, e1], dim=-1)
