"""The port's Viterbi (ngsf_hmm_tpu_torch.models.hmm.viterbi, on the CPU
through the kernel's plain version) against ngsf_hmm_tpu.models.hmm.viterbi
in float64: paths equal, scores to rtol 1e-12."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from ngsf_hmm_tpu.models.hmm import viterbi as j_viterbi
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


@pytest.mark.parametrize("compat", [True, False],
                         ids=["compat", "textbook"])
def test_viterbi_matches_jax(case, compat):
    e, dist, F, alpha = case
    pj, sj = j_viterbi(jnp.asarray(e), jnp.asarray(dist), jnp.asarray(F),
                       jnp.asarray(alpha), compat=compat)
    pt, st = t_viterbi(_t(e), _t(dist), _t(F), _t(alpha), compat=compat)
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
    pt, st = t_viterbi(_t(e), _t(dist), _t(F), _t(alpha),
                       init_logits=_t(il), final_state=_t(fs))
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    assert np.array_equal(pt.numpy()[-1], fs)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-12)


def test_viterbi_tie_keeps_state_zero():
    """Exact ties: F = 0.5 and equal emissions make both states' scores
    equal at every site; the strict > rule keeps k = 0 everywhere, in both
    packages."""
    S, N = 12, 3
    e = np.full((S, N, 2), np.log(0.25))
    dist = np.full(S, np.inf)  # every step draws from q = (0.5, 0.5)
    F = np.full(N, 0.5)
    alpha = np.full(N, 0.3)
    pj, _ = j_viterbi(jnp.asarray(e), jnp.asarray(dist), jnp.asarray(F),
                      jnp.asarray(alpha), compat=False)
    pt, _ = t_viterbi(_t(e), _t(dist), _t(F), _t(alpha), compat=False)
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    assert not pt.any()
