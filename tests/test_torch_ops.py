"""The port's ops (ngsf_hmm_tpu_torch.ops) against the JAX package's
(ngsf_hmm_tpu.ops) on the same numpy inputs, float64, rtol 1e-12: both
are the same formulas in the same order on IEEE doubles; the slack covers
the two libraries' exp/log, and atol 1e-14 covers results that cancel to
about zero (the log-sum of normalised likelihoods)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ngsf_hmm_tpu.ops import emissions as j_em
from ngsf_hmm_tpu.ops import hwe as j_hwe
from ngsf_hmm_tpu.ops import logsum as j_ls
from ngsf_hmm_tpu.ops import maf as j_maf
from ngsf_hmm_tpu.ops import transitions as j_tr
from ngsf_hmm_tpu_torch.ops import emissions as t_em
from ngsf_hmm_tpu_torch.ops import hwe as t_hwe
from ngsf_hmm_tpu_torch.ops import logsum as t_ls
from ngsf_hmm_tpu_torch.ops import maf as t_maf
from ngsf_hmm_tpu_torch.ops import transitions as t_tr

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

RTOL = 1e-12
ATOL = 1e-14


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    S, N = 40, 6
    gl = np.log(rng.dirichlet(np.ones(3), size=(S, N)))
    gl[3, 2] = np.log(1.0 / 3.0)  # a missing-data cell
    maf = rng.uniform(0.01, 0.49, size=S)
    F = rng.uniform(0.0, 1.0, size=N)
    F[0], F[1] = 1.0, 0.0  # the het-floor special case and its opposite
    alpha = rng.uniform(0.01, 2.0, size=N)
    dist = rng.uniform(0.001, 0.3, size=S)
    return gl, maf, F, alpha, dist


def test_logsum_matches_jax(data):
    gl = data[0]
    a, b, c = gl[..., 0], gl[..., 1], gl[..., 2]
    a = a.copy()
    a[0, 0] = b[0, 0] = -np.inf  # the all -inf guard
    _close(t_ls.logsum2(_t(a), _t(b)), j_ls.logsum2(a, b))
    _close(t_ls.logsum3(_t(a), _t(b), _t(c)), j_ls.logsum3(a, b, c))
    _close(t_ls.logsum(_t(gl), dim=-1), j_ls.logsum(jnp.asarray(gl), axis=-1))


@pytest.mark.parametrize("log_scale", [True, False])
def test_calc_hwe_matches_jax(data, log_scale):
    _, maf, F, _, _ = data
    got = t_hwe.calc_hwe(_t(maf)[:, None], _t(F)[None, :], log_scale)
    want = j_hwe.calc_hwe(maf[:, None], F[None, :], log_scale)
    _close(got, want)


def test_post_prob_check_interv_miss_call_match_jax(data):
    gl, maf, F, _, _ = data
    prior = j_hwe.calc_hwe(maf[:, None], F[None, :])
    _close(t_hwe.post_prob(_t(gl), _t(prior)),
           j_hwe.post_prob(jnp.asarray(gl), prior))
    _close(t_hwe.post_prob(_t(gl)), j_hwe.post_prob(jnp.asarray(gl)))
    v = np.array([0.0, 5e-6, 1e-5, 0.3, 1 - 1e-5, 1 - 5e-6, 1.0])
    _close(t_hwe.check_interv(_t(v)), j_hwe.check_interv(jnp.asarray(v)))
    assert np.array_equal(t_hwe.miss_data(_t(gl)).numpy(),
                          np.asarray(j_hwe.miss_data(jnp.asarray(gl))))
    tie = gl.copy()
    tie[5, 1] = np.log([0.4, 0.4, 0.2])  # tie -> lowest index
    _close(t_hwe.call_geno(_t(tie)), j_hwe.call_geno(jnp.asarray(tie)))


def test_transitions_match_jax(data):
    _, _, F, alpha, dist = data
    F = np.clip(F, 0.01, 0.99)
    _close(t_tr.log_q(_t(F)), j_tr.log_q(jnp.asarray(F)))
    for d in (dist[3], np.inf):
        _close(t_tr.trans(_t(F), _t(alpha), d), j_tr.trans(F, alpha, d))
        _close(t_tr.log_trans(_t(F), _t(alpha), d),
               j_tr.log_trans(F, alpha, d))


def test_emissions_match_jax(data):
    gl, maf, _, _, _ = data
    _close(t_em.calc_emission(_t(gl), _t(maf)[:, None]),
           j_em.calc_emission(jnp.asarray(gl), jnp.asarray(maf)[:, None]))
    gl_lin = np.exp(gl)
    _close(t_em.emission_probs_linear(_t(gl_lin), _t(maf)[:, None]),
           j_em.emission_probs_linear(jnp.asarray(gl_lin),
                                      jnp.asarray(maf)[:, None]))


def test_ops_float32(data):
    """float32 in, float32 out, agreeing with the float64 result to
    float32 rounding (rtol 1e-5 on emissions in (0, 1))."""
    gl, maf, _, _, _ = data
    e32 = t_em.calc_emission(_t(gl).float(), _t(maf).float()[:, None])
    assert e32.dtype == torch.float32
    e64 = t_em.calc_emission(_t(gl), _t(maf)[:, None])
    np.testing.assert_allclose(e32.numpy(), e64.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N", [8, 31, 32, 95, 96, 1000])
def test_macro_schedule_equals_jax(N):
    """The est_maf macro schedules and their window lists, equal to the
    JAX package's on both sides of each threshold."""
    assert t_maf.macro_schedule(N) == j_maf.macro_schedule(N)
    for K0, M in ((8, 16), (16, 8), (8, (12, 24, 57))):
        assert t_maf.macro_rounds(K0, M) == j_maf.macro_rounds(K0, M)
    assert (t_maf.MACRO_K0, t_maf.MACRO_MS) == (j_maf.MACRO_K0,
                                                j_maf.MACRO_MS)
