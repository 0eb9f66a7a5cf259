"""The port's emission-slab chain functions (ngsf_hmm_tpu_torch.models
.hmm_kernels_v1, on the CPU through the kernels' plain versions) against
the JAX package's float64 sequential tier (ngsf_hmm_tpu.models.hmm), at
the shapes and gates of tests/test_hmm_pallas.py, and once against the
JAX package's v1 Pallas layer (ngsf_hmm_tpu.models.hmm_pallas, interpret
mode).

Tolerances (those of tests/test_hmm_pallas.py): log-likelihoods rtol 2e-6,
the B = 3 candidate batch rtol 1e-6 against single evaluations, gradients
rtol 2e-3, posteriors atol 2e-5. The port multiplies the site matrices in
order (per-site product) where the Pallas kernels tree-reduce a grid
step's sites, so the two agree to float32 rounding, not bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from ngsf_hmm_tpu.models import hmm as j_hmm
from ngsf_hmm_tpu.models import hmm_pallas as hp
from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
from ngsf_hmm_tpu_torch.models import hmm_kernels_v1 as h1
from test_torch_maf import observed

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

LL_RTOL = 2e-6
G_RTOL = 2e-3
P_ATOL = 2e-5


def _case(S, N, bs, br=0):
    """(e, dist, F, alpha) as numpy float64 + the port's prep and float32
    params; one seed per shape."""
    rng = np.random.default_rng(1000 + S)
    _, _, dist, F, alpha, e = oracle.random_case(rng, S=S, N=N,
                                                 chrom_break_every=br)
    prep = h1.prepare_inputs(torch.as_tensor(e).float(),
                             torch.as_tensor(dist).float(), bs=bs)
    return e, dist, F, alpha, prep, torch.as_tensor(F).float(), \
        torch.as_tensor(alpha).float()


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("S,N,bs,br", [
    (61, 4, 8, 17), (128, 8, 16, 0), (333, 5, 64, 101), (40, 3, 40, 0),
])
def test_forward_loglik_v1_matches_sequential(S, N, bs, br):
    e, dist, F, alpha, prep, Ft, at = _case(S, N, bs, br)
    ll = h1.forward_loglik_v1(Ft[None], at[None], prep)[0]
    ll_s = j_hmm.forward_loglik(*_j(F, alpha, e, dist))
    observed(f"forward_loglik_v1 S={S} (relative)",
             ll.numpy() / np.asarray(ll_s), 1.0)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_s), rtol=LL_RTOL)


def test_forward_loglik_v1_candidate_batch():
    """B > 1 rows equal independent single evaluations and the f64 tier."""
    e, dist, F, alpha, prep, Ft, at = _case(77, 4, 16, 13)
    Fs = torch.stack([Ft, Ft * 0.7, torch.clamp(Ft * 1.2, 0, 0.99)])
    As = torch.stack([at, at * 2.0, at * 0.5])
    ll_b = h1.forward_loglik_v1(Fs, As, prep)
    for k in range(3):
        ll_1 = h1.forward_loglik_v1(Fs[k][None], As[k][None], prep)[0]
        np.testing.assert_allclose(ll_b[k].numpy(), ll_1.numpy(), rtol=1e-6)
        ll_s = j_hmm.forward_loglik(*_j(Fs[k].double().numpy(),
                                        As[k].double().numpy(), e, dist))
        np.testing.assert_allclose(ll_b[k].numpy(), np.asarray(ll_s),
                                   rtol=LL_RTOL)


@pytest.mark.parametrize("S,N,bs,br", [(61, 4, 8, 17), (200, 6, 32, 47)])
def test_loglik_value_and_grad_v1_matches_sequential(S, N, bs, br):
    e, dist, F, alpha, prep, Ft, at = _case(S, N, bs, br)
    L, gF, ga = h1.loglik_value_and_grad_v1(Ft, at, prep)
    L_s, gF_s, ga_s = j_hmm.loglik_value_and_grad(*_j(F, alpha, e, dist))
    assert np.isfinite(gF.numpy()).all() and np.isfinite(ga.numpy()).all()
    for nm, got, want in (("dL/dF", gF, gF_s), ("dL/dalpha", ga, ga_s)):
        observed(f"loglik_value_and_grad_v1 S={S} {nm} (relative)",
                 got.numpy() / np.asarray(want), 1.0)
    np.testing.assert_allclose(L.numpy(), np.asarray(L_s), rtol=LL_RTOL)
    np.testing.assert_allclose(gF.numpy(), np.asarray(gF_s), rtol=G_RTOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ga_s), rtol=G_RTOL)


@pytest.mark.parametrize("S,N,bs,br", [(61, 4, 8, 17), (150, 5, 50, 0)])
def test_posteriors_v1_matches_sequential(S, N, bs, br):
    e, dist, F, alpha, prep, Ft, at = _case(S, N, bs, br)
    p, lf, lb = h1.posteriors_v1(Ft, at, prep)
    p_s, lf_s, lb_s = j_hmm.posteriors(*_j(e, dist, F, alpha))
    observed(f"posteriors_v1 S={S} p", p.numpy(), p_s)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_s), atol=P_ATOL)
    np.testing.assert_allclose(lf.numpy(), np.asarray(lf_s), rtol=LL_RTOL)
    np.testing.assert_allclose(lb.numpy(), np.asarray(lb_s), rtol=LL_RTOL)


def test_v1_matches_pallas_interpret():
    """posteriors_v1 / loglik_value_and_grad_v1 against the JAX v1 Pallas
    layer in interpret mode (posteriors_pallas,
    loglik_value_and_grad_pallas), same shape and gates."""
    e, dist, F, alpha, prep, Ft, at = _case(61, 4, 8, 17)
    with pytest.MonkeyPatch.context() as mp:
        # the package's own sites-per-grid-step knob: short traces
        mp.setenv("NGSF_PALLAS_R", "8")
        jprep = hp.prepare_inputs(*_j(e, dist), bs=8)
        Fj, aj = _j(F.astype(np.float32), alpha.astype(np.float32))
        post_j = [np.asarray(x) for x in hp.posteriors_pallas(Fj, aj, jprep)]
        vag_j = [np.asarray(x) for x in
                 hp.loglik_value_and_grad_pallas(Fj, aj, jprep)]
    p, lf, lb = h1.posteriors_v1(Ft, at, prep)
    observed("posteriors_v1 against posteriors_pallas p", p.numpy(),
             post_j[0])
    np.testing.assert_allclose(p.numpy(), post_j[0], atol=P_ATOL)
    np.testing.assert_allclose(lf.numpy(), post_j[1], rtol=LL_RTOL)
    np.testing.assert_allclose(lb.numpy(), post_j[2], rtol=LL_RTOL)
    L, gF, ga = h1.loglik_value_and_grad_v1(Ft, at, prep)
    np.testing.assert_allclose(L.numpy(), vag_j[0], rtol=LL_RTOL)
    np.testing.assert_allclose(gF.numpy(), vag_j[1], rtol=G_RTOL)
    np.testing.assert_allclose(ga.numpy(), vag_j[2], rtol=G_RTOL)


def test_v1_grad_primal_rows_bit_identical_to_transfer():
    """The grad plain version's primal rows and offset equal the transfer
    plain version's output at B = 1 (torch.equal), as for the v2 pair."""
    _, _, _, _, prep, Ft, at = _case(333, 5, 64, 101)
    A_g = h1.transfer_grad_v1(Ft, at, prep)
    A_r, _ = h1.block_transfers_v1(Ft[None], at[None], prep)
    assert A_g.shape == (prep["nb"], 13, 1, 5)
    assert A_r.shape == (prep["nb"], 5, 1, 5)
    assert torch.equal(torch.cat([A_g[:, 0:4], A_g[:, 12:13]], dim=1), A_r)
    # posteriors reuse a transfer pass bit for bit, and the raw slab is
    # the one the unpack reads
    p0, lf0, _ = h1.posteriors_v1(Ft, at, prep)
    p1, lf1, _, slab = h1.posteriors_v1(
        Ft, at, prep, A_reps=h1.block_transfers_v1(Ft[None], at[None], prep),
        return_slab=True)
    assert torch.equal(p0, p1) and torch.equal(lf0, lf1)
    assert torch.equal(hk._unpack_sites2(slab, prep), p1)


def test_v1_layout_pads_are_exact_no_ops():
    """Pad sites hold e = 1 and d = 0; the default geometry is
    pick_geom2(S, L); a chain padded to a longer last block gives the same
    log-likelihood as the unpadded layout's."""
    e, dist, _, _, prep, Ft, at = _case(61, 4, 8, 17)
    assert (prep["bs"], prep["nb"]) == (8, 8) and prep["N"] == 4
    assert torch.equal(prep["e0"][5:, 7], torch.ones((3, 4)))
    assert torch.equal(prep["dc"][5:, 7], torch.zeros(3))
    auto = h1.prepare_inputs(torch.as_tensor(e).float(),
                             torch.as_tensor(dist).float())
    assert (auto["bs"], auto["nb"]) == hk.pick_geom2(61, 4)
    ll = h1.forward_loglik_v1(Ft[None], at[None], prep)[0]
    ll_auto = h1.forward_loglik_v1(Ft[None], at[None], auto)[0]
    np.testing.assert_allclose(ll.numpy(), ll_auto.numpy(), rtol=1e-6)


def _f32(x):
    return torch.as_tensor(np.asarray(x)).float()


def _product_rule_grad_loop(site, dc, shape, F, alpha):
    """The transfer+tangent loop in its earlier form (kept here as the
    reference of the tangent rewrite): the product rule written out,
    d(C M) = dC M + C dM, with dM/dF and dM/dalpha as full 2x2 matrices."""
    bs, nb, N = shape
    Fb, ab = F[None, :], alpha[None, :]
    one = torch.ones((nb, N), dtype=torch.float32)
    zero = torch.zeros_like(one)
    c, cF, ca = (one, zero, zero, one.clone()), (zero,) * 4, (zero,) * 4
    ex = torch.zeros((nb, N), dtype=torch.int32)
    for r in range(bs):
        e0, e1, x, onem = site(r, ab)
        m = hk._site_matrix_plain(e0, e1, x, onem, Fb)
        dxp = torch.where(x > 0.0, dc[r][:, None] * x, torch.zeros_like(x))
        oe0, oe1 = onem * e0, onem * e1
        fd, gd = Fb * dxp, (1.0 - Fb) * dxp
        mF = (-oe0, oe1, -oe0, oe1)
        ma = (-fd * e0, fd * e1, gd * e0, -gd * e1)
        n = hk._mm4(c, m)
        nF = tuple(p + q for p, q in zip(hk._mm4(cF, m), hk._mm4(c, mF)))
        na = tuple(p + q for p, q in zip(hk._mm4(ca, m), hk._mm4(c, ma)))
        sc, e = hk._pow2_rescale(hk._tiny(hk._max4(*n)))
        c = tuple(v * sc for v in n)
        cF = tuple(v * sc for v in nF)
        ca = tuple(v * sc for v in na)
        ex = ex + e
    return torch.stack(c + cF + ca + (ex.to(torch.float32) * hk._LN2,))


def test_tangent_rewrite_matches_product_rule():
    """The plain version's factored tangents (hk._tangent_step: the order
    of csrc/block_transfer_grad.cu, shared by the v1 loop) against the product rule written out, at
    257 sites x 6 individuals with a chromosome break (d = inf, x = 0),
    pad sites (the f = 2 sentinel) and F = 0 and F = 1. Primal rows and
    offset bit-equal (untouched); tangents within 1e-6 of each lane's
    largest entry: the same terms summed in another order, and rounded
    once per fused multiply-add (7.4e-7 seen)."""
    rng = np.random.default_rng(71)
    S, N = 257, 6
    gl = rng.dirichlet(np.ones(3), size=(S, N)).astype(np.float32)
    dist = (rng.random(S) * 0.05).astype(np.float32)
    dist[0], dist[120] = 0.5, np.inf
    freq = rng.uniform(0.02, 0.6, S).astype(np.float32)
    F = _f32([0.0, 1.0, 0.3, 0.05, 0.93, 0.5])
    alpha = _f32(rng.uniform(0.2, 4.0, N))
    prep = hk.prepare_gl_inputs(_f32(gl), _f32(dist))
    fc = hk.freq_compact(_f32(freq), prep)
    assert prep["nb"] * prep["bs"] > S and bool((fc == 2.0).any())
    args = (prep["g0"], prep["g2"], fc, prep["dc"])
    got = hk._block_transfer_grad_plain(*args, F, alpha)
    want = _product_rule_grad_loop(hk._gl_site(*args), prep["dc"],
                                   prep["g0"].shape, F, alpha)
    assert torch.equal(got[:4], want[:4]) and torch.equal(got[12], want[12])
    for lo in (4, 8):
        scale = want[lo:lo + 4].abs().amax(0).clamp_min(1e-30)
        err = float(((got[lo:lo + 4] - want[lo:lo + 4]).abs() / scale).max())
        assert err <= 1e-6, (lo, err)
    assert bool(torch.isfinite(got).all())
