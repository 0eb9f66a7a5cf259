"""The LD path's host math (ngsf_hmm_tpu_torch/ops/haplo.py, the LD init)
against the JAX package (ngsf_hmm_tpu/ops/haplo.py, io/init.py,
models/em.init_state), on the CPU.

The same inputs, made by numpy from fixed seeds, go through both. Plain
torch on one side, XLA on the other: the sums run in other orders, so
the tolerances are float64 rtol 1e-10 and float32 rtol 2e-6, with an
atol in float32 where values near 0 lose their relative precision:
haplotype freqs 1e-8 (a freq that the EM drives towards 0 ends at 1e-23
or as a denormal on either side; the four sum to 1), log emissions 2e-6
(log(total) - e_prev cancels to values near 0 at some cells).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ngsf_hmm_tpu.io.gsl_rng import GslTaus as JGslTaus
from ngsf_hmm_tpu.io.init import init_freq as j_init_freq
from ngsf_hmm_tpu.models import em as j_em
from ngsf_hmm_tpu.ops import haplo as j_haplo
from ngsf_hmm_tpu_torch.io.gsl_rng import GslTaus
from ngsf_hmm_tpu_torch.io.init import init_freq
from ngsf_hmm_tpu_torch.models import em as t_em
from ngsf_hmm_tpu_torch.ops import haplo as t_haplo

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

TOL = {np.float64: dict(rtol=1e-10), np.float32: dict(rtol=2e-6)}
DTYPES = pytest.mark.parametrize("dt", [np.float64, np.float32],
                                 ids=["f64", "f32"])


def _log_gl(rng, S, N, dt):
    """Normalised log GLs [S, N, 3] with informative genotypes drawn from
    per-site freqs and LD between neighbours (each site copies its left
    neighbour's genotype with probability 0.5)."""
    maf = rng.uniform(0.1, 0.4, S)
    geno = rng.binomial(2, maf[:, None], size=(S, N))
    copy = rng.random((S, N)) < 0.5
    for s in range(1, S):
        geno[s] = np.where(copy[s], geno[s - 1], geno[s])
    raw = 0.05 + 0.3 * rng.random((S, N, 3))
    np.put_along_axis(raw, geno[..., None],
                      np.take_along_axis(raw, geno[..., None], 2) + 1.0, 2)
    return np.log(raw / raw.sum(-1, keepdims=True)).astype(dt)


def _pairs(dt, seed=41, S=40, N=8):
    rng = np.random.default_rng(seed)
    gl = _log_gl(rng, S, N, dt)
    f = rng.uniform(0.05, 0.45, S).astype(dt)
    return gl, f


def test_haplo_freq_compat_is_nan():
    """compat=True reproduces the reference's NaN outcome
    (gen_func.cpp:1160), shape [..., 4]."""
    gl, f = _pairs(np.float64)
    got = t_haplo.haplo_freq(torch.as_tensor(gl[:-1]),
                             torch.as_tensor(gl[1:]), torch.as_tensor(f[:-1]),
                             torch.as_tensor(f[1:]), compat=True)
    want = np.asarray(j_haplo.haplo_freq(jnp.asarray(gl[:-1]),
                                         jnp.asarray(gl[1:]), f[:-1], f[1:],
                                         compat=True))
    assert got.shape == want.shape == (len(f) - 1, 4)
    assert torch.isnan(got).all() and np.isnan(want).all()


@DTYPES
def test_haplo_freq_matches_jax(dt):
    """The corrected pair EM, all pairs under one global stop test."""
    gl, f = _pairs(dt)
    got = t_haplo.haplo_freq(torch.as_tensor(gl[:-1]),
                             torch.as_tensor(gl[1:]), torch.as_tensor(f[:-1]),
                             torch.as_tensor(f[1:]), compat=False)
    want = np.asarray(j_haplo.haplo_freq(jnp.asarray(gl[:-1]),
                                         jnp.asarray(gl[1:]),
                                         jnp.asarray(f[:-1]),
                                         jnp.asarray(f[1:]), compat=False))
    assert got.dtype == torch.as_tensor(gl).dtype
    tol = dict(TOL[dt], atol=1e-8 if dt == np.float32 else 0)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, rtol=1e-5)


def test_haplo_freq_chunked_equals_unchunked():
    """Chunks of pairs change no value: chunk=7 (ragged last chunk) and
    chunk=1 equal the one-chunk run exactly, float64."""
    gl, f = _pairs(np.float64, seed=7)
    args = (torch.as_tensor(gl[:-1]), torch.as_tensor(gl[1:]),
            torch.as_tensor(f[:-1]), torch.as_tensor(f[1:]))
    whole = t_haplo.haplo_freq(*args, compat=False)
    for chunk in (7, 1):
        assert torch.equal(t_haplo.haplo_freq(*args, compat=False,
                                              chunk=chunk), whole)
    em = t_haplo.ld_emissions(whole, torch.as_tensor(gl), torch.as_tensor(f))
    assert torch.equal(t_haplo.ld_emissions(whole, torch.as_tensor(gl),
                                            torch.as_tensor(f), chunk=5), em)


def test_joint_geno_prob_matches_jax():
    """Both IBD states' 3 x 3 pair tables, float64 (exact products)."""
    rng = np.random.default_rng(3)
    hap = rng.dirichlet(np.ones(4), size=9)
    F = np.array([0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    got = t_haplo.joint_geno_prob(torch.as_tensor(hap), torch.as_tensor(F))
    want = np.asarray(j_haplo.joint_geno_prob(jnp.asarray(hap),
                                              jnp.asarray(F)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    np.testing.assert_allclose(got.numpy().sum((-1, -2)), 1.0, rtol=1e-12)


@DTYPES
def test_calc_emission_ld_matches_jax(dt):
    """LD log emissions of both states for every (pair, individual)."""
    gl, f = _pairs(dt, seed=11)
    hap = j_haplo.haplo_freq(jnp.asarray(gl[:-1]), jnp.asarray(gl[1:]),
                             jnp.asarray(f[:-1]), jnp.asarray(f[1:]),
                             compat=False)
    hap_t = torch.as_tensor(np.asarray(hap))
    tol = dict(TOL[dt], atol=2e-6 if dt == np.float32 else 0)
    for k in (0, 1):
        got = t_haplo.calc_emission_ld(
            hap_t[:, None, :], torch.as_tensor(gl[:-1]),
            torch.as_tensor(gl[1:]), torch.as_tensor(f[:-1, None]), k)
        want = np.asarray(j_haplo.calc_emission_ld(
            hap[:, None, :], jnp.asarray(gl[:-1]), jnp.asarray(gl[1:]),
            jnp.asarray(f[:-1, None]), k))
        np.testing.assert_allclose(got.numpy(), want, **tol)


@DTYPES
def test_ld_init_freq_matches_jax(dt):
    """--freq e under --freq_est 2: site 0 from est_maf(F = 0), the rest
    from the pair EM seeded with the est_maf freqs."""
    gl, _ = _pairs(dt, seed=19)
    got = t_haplo.ld_init_freq(torch.as_tensor(gl))
    want = np.asarray(j_haplo.ld_init_freq(jnp.asarray(gl)))
    np.testing.assert_allclose(got.numpy(), want, **TOL[dt])


def test_init_freq_e_under_freq_est_2_matches_jax():
    """io/init.init_freq("e", freq_est=2) returns ld_init_freq's values as
    a numpy array, as the JAX package's does (float64)."""
    gl, _ = _pairs(np.float64, seed=23)
    got = init_freq("e", 40, GslTaus(5), gl=gl, freq_est=2, device="cpu")
    want = j_init_freq("e", 40, JGslTaus(5), gl=jnp.asarray(gl), freq_est=2)
    assert isinstance(got, np.ndarray) and got.shape == (40,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10)


@DTYPES
def test_init_state_ld_matches_jax(dt):
    """init_state(e_prob_calc=2) against JAX init_state (em.py:114): site 0
    keeps the plain emission, sites >= 1 carry the LD pair emissions."""
    gl, f = _pairs(dt, seed=29)
    F0 = np.full(8, 0.3, dt)
    a0 = np.full(8, 0.05, dt)
    got = t_em.init_state(gl, f, F0, a0, e_prob_calc=2, device="cpu",
                          dtype=torch.as_tensor(gl).dtype)
    want = j_em.init_state(jnp.asarray(gl), jnp.asarray(f), jnp.asarray(F0),
                           jnp.asarray(a0), e_prob_calc=2)
    tol = dict(TOL[dt], atol=2e-6 if dt == np.float32 else 0)
    np.testing.assert_allclose(got.e_prob.numpy(), np.asarray(want.e_prob),
                               **tol)
    plain = t_em.init_state(gl, f, F0, a0, device="cpu",
                            dtype=torch.as_tensor(gl).dtype)
    assert torch.equal(got.e_prob[0], plain.e_prob[0])
    assert float((got.e_prob[1:] - plain.e_prob[1:]).abs().max()) > 1e-3
    for k in ("freq", "indF", "alpha", "p_ibd", "ind_lkl"):
        assert torch.equal(getattr(got, k), getattr(plain, k))
