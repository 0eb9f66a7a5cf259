"""Genotype-prior math: HWE-with-inbreeding priors and posterior normalisation.

Vectorised over arbitrary leading batch dimensions:

- :func:`calc_hwe`  <-> calc_HWE   (reference: shared/gen_func.cpp:938-957)
- :func:`post_prob` <-> post_prob  (reference: shared/gen_func.cpp:920-932)
- :func:`check_interv` <-> check_interv (reference: shared/gen_func.cpp:55-70)

All log-space values use ``-BIG`` (=-1e15) instead of ``-inf`` exactly as
the reference does (conv_space, gen_func.cpp:123-130), which keeps
``gl + prior`` NaN-free.
"""

import math

import torch

from ..utils.constants import BIG, EPSILON
from .logsum import logsum3


def calc_hwe(maf, F, log_scale=True):
    """Genotype frequencies under HWE with inbreeding coefficient ``F``.

    maf, F: broadcastable tensors (linear space). Returns a tensor with a
    trailing axis of size 3 (genotypes AA, Aa, aa). When ``F == 1``
    exactly, the heterozygote probability is floored to ``1/BIG`` (log:
    ``-BIG``) rather than 0 (reference: gen_func.cpp:946-956).
    """
    maf, F = torch.broadcast_tensors(maf, F)
    pq = (1.0 - maf) * maf
    g0 = (1.0 - maf) * (1.0 - maf) + pq * F
    g1 = 2.0 * pq - 2.0 * pq * F
    g2 = maf * maf + pq * F
    if log_scale:
        lg = torch.log(torch.stack([g0, g1, g2], dim=-1))
        lg = torch.where(torch.isneginf(lg), torch.full_like(lg, -BIG), lg)
        het = torch.where(F == 1.0, torch.full_like(g1, -BIG), lg[..., 1])
        return torch.stack([lg[..., 0], het, lg[..., 2]], dim=-1)
    het = torch.where(F == 1.0, torch.full_like(g1, 1.0 / BIG), g1)
    return torch.stack([g0, het, g2], dim=-1)


def post_prob(lkl, prior=None):
    """Normalised log posteriors [..., 3] from log-likelihoods and an
    optional log prior (gen_func.cpp:920-932, index-order log-sum)."""
    pp = lkl if prior is None else lkl + prior
    norm = logsum3(pp[..., 0], pp[..., 1], pp[..., 2])
    return pp - norm[..., None]


def check_interv(value):
    """Snap values within EPSILON of {0, 1} to exactly {0, 1}
    (gen_func.cpp:55-70; NaN propagates)."""
    value = torch.where(value < EPSILON, torch.zeros_like(value), value)
    return torch.where(value > 1.0 - EPSILON, torch.ones_like(value), value)


def miss_data(gl):
    """True where a genotype's three log-likelihoods are all (EPSILON-)equal
    (gen_func.cpp:862-868). ``gl``: [..., 3]."""
    return (torch.abs(gl[..., 0] - gl[..., 1]) < EPSILON) & (
        torch.abs(gl[..., 1] - gl[..., 2]) < EPSILON
    )


def call_geno(gl):
    """Call genotypes from normalised log-probabilities [..., 3]: missing
    sites (all three equal) become uniform ``log(1/3)``, all others snap
    to a one-hot at the highest-probability genotype, ties to the lowest
    index (gen_func.cpp:886-914 with the defaults of gen_func.hpp:98)."""
    # first index of the maximum (torch.argmax leaves tie order open)
    ge01 = gl[..., 0] >= gl[..., 1]
    max_pos = torch.where(
        ge01,
        torch.where(gl[..., 0] >= gl[..., 2], 0, 2),
        torch.where(gl[..., 1] >= gl[..., 2], 1, 2),
    )
    missing = (gl[..., 0] == gl[..., 2]) & (gl[..., 0] == gl[..., 1])
    idx = torch.arange(3, device=gl.device)
    one_hot = torch.where(
        idx == max_pos[..., None],
        torch.zeros_like(gl),
        torch.full_like(gl, -BIG),
    )
    uniform = torch.full_like(gl, math.log(1.0 / 3.0))
    return torch.where(missing[..., None], uniform, one_hot)
