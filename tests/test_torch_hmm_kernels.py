"""The port's chain functions (ngsf_hmm_tpu_torch.models.hmm_kernels, on
the CPU through the kernels' plain versions) against the JAX package's
fused Pallas layer (ngsf_hmm_tpu.models.hmm_pallas, interpret mode) and
against the float64 sequential tier (ngsf_hmm_tpu.models.hmm).

Tolerances: log-likelihoods rtol 2e-6 and posteriors / gradients as in
tests/test_hmm_pallas_fused.py -- float32 chains whose per-site product
(here) and tree product (JAX) associate differently, so values agree to
float32 rounding, not bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from ngsf_hmm_tpu.models import hmm as j_hmm
from ngsf_hmm_tpu.models import hmm_pallas as hp
from ngsf_hmm_tpu_torch.models import hmm as t_hmm
from ngsf_hmm_tpu_torch.models import hmm_kernels as hk

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

# (S, N, chromosome break every, through the Pallas layer too?). Each
# Pallas interpret-mode trace costs seconds, so only the first shape (the
# one with breaks and a ragged last block) pays for it; the second is
# held against the float64 sequential tier alone.
CASES = [(333, 5, 101, True), (130, 11, 0, False)]
P_ATOL = 2e-5
LL_RTOL = 2e-6


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"S{c[0]}N{c[1]}")
def case(request):
    S, N, br, fused = request.param
    rng = np.random.default_rng(37 + S)
    gl, freq, dist, F, alpha, e = oracle.random_case(
        rng, S=S, N=N, chrom_break_every=br)
    gl_lin = np.exp(np.transpose(gl, (1, 0, 2)))  # [S, N, 3]
    # JAX side: fused Pallas (interpret) + the f64 sequential tier
    jp = jfc = None
    if fused:
        jp = hp.prepare_gl_inputs(jnp.asarray(gl_lin), jnp.asarray(dist))
        jfc = hp.freq_compact(jnp.asarray(freq), jp)
    Fj, aj = jnp.asarray(F), jnp.asarray(alpha)
    with pytest.MonkeyPatch.context() as mp:
        # the package's own sites-per-grid-step knob: 8 rows a step keep
        # the interpret-mode traces short (same math, 8x less unrolling)
        mp.setenv("NGSF_PALLAS_R", "8")
        ref = _jax_reference(jp, jfc, Fj, aj, e, dist, fused)
    # port side
    prep = hk.prepare_gl_inputs(_t(gl_lin), _t(dist))
    fc = hk.freq_compact(_t(freq), prep)
    assert prep["nb"] * prep["bs"] > S or S % prep["bs"] == 0
    return dict(prep=prep, fc=fc, F=_t(F), alpha=_t(alpha), ref=ref,
                e=e, dist=dist, S=S, N=N, br=br)


def _jax_reference(jp, jfc, Fj, aj, e, dist, fused):
    ref = dict(
        ll_seq=np.asarray(j_hmm.forward_loglik(Fj, aj, jnp.asarray(e),
                                               jnp.asarray(dist))),
        vag_seq=[np.asarray(x) for x in j_hmm.loglik_value_and_grad(
            Fj, aj, jnp.asarray(e), jnp.asarray(dist))],
        post_seq=[np.asarray(x) for x in j_hmm.posteriors(
            jnp.asarray(e), jnp.asarray(dist), Fj, aj)],
    )
    # without the Pallas layer the sequential tier stands in for it
    ref.update(ll_fused=ref["ll_seq"], vag_fused=ref["vag_seq"],
               post_fused=ref["post_seq"])
    if fused:
        ref.update(
            ll_fused=np.asarray(hp.forward_loglik_fused(
                Fj[None], aj[None], jp, jfc)[0]),
            vag_fused=[np.asarray(x) for x in
                       hp.loglik_value_and_grad_fused(Fj, aj, jp, jfc)],
            post_fused=[np.asarray(x) for x in
                        hp.posteriors_fused(Fj, aj, jp, jfc)],
        )
    return ref


def test_forward_loglik_fused_matches_jax(case):
    ll = hk.forward_loglik_fused(case["F"][None], case["alpha"][None],
                                 case["prep"], case["fc"])[0].numpy()
    np.testing.assert_allclose(ll, case["ref"]["ll_fused"], rtol=LL_RTOL)
    np.testing.assert_allclose(ll, case["ref"]["ll_seq"], rtol=LL_RTOL)


def test_loglik_value_and_grad_fused_matches_jax(case):
    ll, gF, ga = [x.numpy() for x in hk.loglik_value_and_grad_fused(
        case["F"], case["alpha"], case["prep"], case["fc"])]
    assert np.isfinite(gF).all() and np.isfinite(ga).all()  # chr breaks
    for ref, rtol in ((case["ref"]["vag_fused"], 2e-4),
                      (case["ref"]["vag_seq"], 2e-4)):
        np.testing.assert_allclose(ll, ref[0], rtol=LL_RTOL)
        np.testing.assert_allclose(gF, ref[1], rtol=rtol, atol=2e-3)
        np.testing.assert_allclose(ga, ref[2], rtol=rtol, atol=2e-3)


def test_posteriors_fused_matches_jax(case):
    F, a, prep, fc = case["F"], case["alpha"], case["prep"], case["fc"]
    p, ll_f, ll_b = hk.posteriors_fused(F, a, prep, fc)
    for ref in (case["ref"]["post_fused"], case["ref"]["post_seq"]):
        np.testing.assert_allclose(p.numpy(), ref[0], atol=P_ATOL)
        np.testing.assert_allclose(ll_f.numpy(), ref[1], rtol=LL_RTOL)
        np.testing.assert_allclose(ll_b.numpy(), ref[2], rtol=LL_RTOL)
    # float64 log-likelihoods: fw and bw agree far inside lkl_check_tol
    assert float((ll_f - ll_b).abs().max()) < 1e-3


def test_posteriors_fused_A_reps_and_slab(case):
    """A_reps reuse reproduces the separate transfer pass bit for bit, and
    return_slab hands the raw slab on untouched."""
    F, a, prep, fc = case["F"], case["alpha"], case["prep"], case["fc"]
    p0, lf0, lb0 = hk.posteriors_fused(F, a, prep, fc)
    A_g, A_reps = hk.transfer_grad_reps_fused(F, a, prep, fc)
    p1, lf1, lb1, slab = hk.posteriors_fused(F, a, prep, fc, A_reps=A_reps,
                                             return_slab=True)
    assert torch.equal(p0, p1) and torch.equal(lf0, lf1)
    assert torch.equal(lb0, lb1)
    assert slab.shape == (prep["bs"], prep["nb"], case["N"])
    assert torch.equal(hk._unpack_sites2(slab, prep), p1)
    none_p, _, _, slab2 = hk.posteriors_fused(
        F, a, prep, fc, A_reps=A_reps, return_slab=True, return_p=False)
    assert none_p is None and torch.equal(slab, slab2)
    # pack/unpack are inverses
    assert torch.equal(hk._unpack_sites2(hk.pack_sites2(p1, prep), prep), p1)


def test_grad_primal_rows_bit_identical_to_transfer(case):
    """The fused transfer+tangent plain version's primal rows and offset
    equal the transfer plain version's output at B = 1 (the A_reps reuse
    and the f0g0 seed depend on it)."""
    F, a, prep, fc = case["F"], case["alpha"], case["prep"], case["fc"]
    A_g, (A_r, _) = hk.transfer_grad_reps_fused(F, a, prep, fc)
    A4, _ = hk.block_transfers_fused(F[None], a[None], prep, fc)
    assert A_g.shape == (prep["nb"], 13, 1, case["N"])
    assert A4.shape == (prep["nb"], 5, 1, case["N"])
    assert torch.equal(A_r, A4)
    ll, gF, ga = hk.grad_from_carries(A_g, F)
    ll2, gF2, ga2 = hk.loglik_value_and_grad_fused(F, a, prep, fc)
    assert torch.equal(ll, ll2) and torch.equal(gF, gF2)
    assert torch.equal(ga, ga2)


def test_candidate_batch_and_sequential_tier(case):
    """B = 3 candidates through the transfer kernel's plain version, held
    against the port's own float64 sequential tier (which in turn is held
    against the JAX one here, rtol 1e-10)."""
    F, a, prep, fc = case["F"], case["alpha"], case["prep"], case["fc"]
    Fs = torch.stack([F, F * 0.7, torch.clamp(F * 1.2, 0, 0.99)])
    As = torch.stack([a, a * 2.0, a * 0.5])
    ll_b = hk.forward_loglik_fused(Fs, As, prep, fc)
    e64, d64 = _t(case["e"], torch.float64), _t(case["dist"], torch.float64)
    for k in range(3):
        ll_s = t_hmm.forward_loglik(Fs[k].double(), As[k].double(), e64, d64)
        np.testing.assert_allclose(ll_b[k].numpy(), ll_s.numpy(),
                                   rtol=LL_RTOL)
    F64, a64 = F.double(), a.double()
    p, lf, lb = t_hmm.posteriors(e64, d64, F64, a64)
    L, gF, ga = t_hmm.loglik_value_and_grad(F64, a64, e64, d64)
    Fj, aj = jnp.asarray(F64.numpy()), jnp.asarray(a64.numpy())
    pj, lfj, lbj = j_hmm.posteriors(jnp.asarray(case["e"]),
                                    jnp.asarray(case["dist"]), Fj, aj)
    Lj, gFj, gaj = j_hmm.loglik_value_and_grad(
        Fj, aj, jnp.asarray(case["e"]), jnp.asarray(case["dist"]))
    for got, want in ((p, pj), (lf, lfj), (lb, lbj), (L, Lj), (gF, gFj),
                      (ga, gaj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-12)


def test_geometry_and_refusals():
    bs, nb = hk.pick_geom2(1_000_000, 100)
    assert nb * bs >= 1_000_000 and (nb - 1) * bs < 1_000_000
    assert nb * 100 >= 132 * 1024  # enough lanes to fill the card
    assert hk.pick_geom2(10, 3) == (10, 1)
    A = torch.zeros((2, 5, 1, 3))
    with pytest.raises(NotImplementedError):
        hk._combine_blocks(A, torch.full((1, 3), 0.1),
                           v0=torch.zeros((1, 3, 2)))
