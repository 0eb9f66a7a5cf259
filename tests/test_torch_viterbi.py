"""The port's Viterbi (ngsf_hmm_tpu_torch.models.hmm.viterbi, on the CPU
through the kernel's plain version) against ngsf_hmm_tpu.models.hmm.viterbi
in float64: paths equal, scores to rtol 1e-12.

The traceback runs in blocks of L sites (composed back-pointer maps, then
every block decoded from its exit state); the cases cover the default
block, single-site blocks, blocks that cut the chromosome breaks (every 90
sites) and one block longer than S = 257."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from ngsf_hmm_tpu.models.hmm import viterbi as j_viterbi
from ngsf_hmm_tpu_torch.models import hmm as t_hmm
from ngsf_hmm_tpu_torch.models.hmm import viterbi as t_viterbi

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    gl, freq, dist, F, alpha, e = oracle.random_case(
        rng, S=257, N=7, chrom_break_every=90)
    return e, dist, F, alpha


# (compat, traceback block length; None: the default VITERBI_BLOCK)
VARIANTS = [(True, None), (False, None)] + [
    (c, L) for L in (1, 8, 64, 300) for c in (True, False)]


@pytest.mark.parametrize(
    "compat,L", VARIANTS,
    ids=[("compat" if c else "textbook") + ("" if L is None else f"-L{L}")
         for c, L in VARIANTS])
def test_viterbi_matches_jax(case, compat, L):
    e, dist, F, alpha = case
    pj, sj = j_viterbi(jnp.asarray(e), jnp.asarray(dist), jnp.asarray(F),
                       jnp.asarray(alpha), compat=compat)
    kw = {} if L is None else dict(L=L)
    pt, st = t_viterbi(_t(e), _t(dist), _t(F), _t(alpha), compat=compat,
                       **kw)
    assert pt.dtype == torch.int8 and pt.shape == (257, 7)
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-12)
    assert 0 < pt.float().mean() < 1  # both states decoded


def test_viterbi_boundary_hooks_match_jax(case):
    e, dist, F, alpha = case
    rng = np.random.default_rng(6)
    il = np.log(rng.dirichlet(np.ones(2), size=7))
    fs = rng.integers(0, 2, size=7).astype(np.int8)
    pj, sj = j_viterbi(jnp.asarray(e), jnp.asarray(dist), jnp.asarray(F),
                       jnp.asarray(alpha), init_logits=jnp.asarray(il),
                       final_state=jnp.asarray(fs))
    for L in (t_hmm.VITERBI_BLOCK, 8, 300):
        pt, st = t_viterbi(_t(e), _t(dist), _t(F), _t(alpha),
                           init_logits=_t(il), final_state=_t(fs), L=L)
        assert np.array_equal(pt.numpy(), np.asarray(pj))
        assert np.array_equal(pt.numpy()[-1], fs)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-12)


def test_viterbi_tie_keeps_state_zero():
    """Exact ties: F = 0.5 and equal emissions make both states' scores
    equal at every site; the strict > rule keeps k = 0 everywhere, in both
    packages, with traceback blocks shorter than S too."""
    S, N = 12, 3
    e = np.full((S, N, 2), np.log(0.25))
    dist = np.full(S, np.inf)  # every step draws from q = (0.5, 0.5)
    F = np.full(N, 0.5)
    alpha = np.full(N, 0.3)
    pj, _ = j_viterbi(jnp.asarray(e), jnp.asarray(dist), jnp.asarray(F),
                      jnp.asarray(alpha), compat=False)
    for L in (t_hmm.VITERBI_BLOCK, 5):
        pt, _ = t_viterbi(_t(e), _t(dist), _t(F), _t(alpha), compat=False,
                          L=L)
        assert np.array_equal(pt.numpy(), np.asarray(pj))
        assert not pt.any()


def test_traceback_blocked_equals_sequential():
    """The blocked traceback against the plain per-site one, on random
    back-pointer codes (every map of {0, 1}, the swap included, which a
    Viterbi pass rarely gives), for blocks of one site, blocks that do and
    do not divide S, and one block longer than S."""
    rng = np.random.default_rng(8)
    S, N = 203, 6
    codes = torch.as_tensor(rng.integers(0, 4, (S, N)), dtype=torch.uint8)
    last = torch.as_tensor(rng.integers(0, 2, N), dtype=torch.uint8)
    want = torch.empty((S, N), dtype=torch.int8)
    cur = last.clone()
    for s in range(S - 1, -1, -1):
        want[s] = cur
        cur = (codes[s] >> cur) & 1
    for L in (1, 3, 7, 29, 256):
        assert torch.equal(t_hmm._traceback_blocked(codes, last, L), want)
