"""The scan tier's kernels through their plain versions (CPU, float64):
the blocked log-space chain of ngsf_hmm_tpu_torch.models.hmm
(log_block_transfer, log_combine, log_sweep; csrc/log_chain.cu) and the
log-space est_maf (ops/maf.est_maf -> maf_log; csrc/maf_log.cu), against
the JAX package's float64 scan tier (ngsf_hmm_tpu.models.hmm,
ngsf_hmm_tpu.ops.maf) and against the port's per-site oracle loops.

The shape: S = 397 sites, N = 7 individuals, chromosome breaks, one site
at distance 0 (the identity transition), so log_geometry gives 12 blocks
of 34 sites, the last one 23.

Tolerances: log-likelihoods (ll_f, ll_b) rtol 1e-10 and p_ibd atol 1e-10
(the blocked chain associates the same float64 steps otherwise than the
scan); dL/dF and dL/dalpha rtol 1e-9, the JAX package's own gate of its
analytic gradient against autodiff (tests/test_hmm.py:124); est_maf's
freq rtol 1e-10 (the sum over individuals runs in another order; a site
whose |prev - freq| lands within rounding of EPSILON could stop one pass
apart, and is reported).
"""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from ngsf_hmm_tpu.models import hmm as j_hmm
from ngsf_hmm_tpu.ops import maf as j_maf
from test_torch_maf import observed
from ngsf_hmm_tpu_torch.models import hmm as t_hmm
from ngsf_hmm_tpu_torch.ops import maf as t_maf
from ngsf_hmm_tpu_torch.utils import cuda_lib

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

S, N = 397, 7
LL_RTOL, P_ATOL, G_RTOL, MAF_RTOL = 1e-10, 1e-10, 1e-9, 1e-10


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(41)
    gl, freq, dist, F, alpha, e = oracle.random_case(
        rng, S=S, N=N, chrom_break_every=101)
    dist[57] = 0.0
    args_j = (jnp.asarray(F), jnp.asarray(alpha), jnp.asarray(e),
              jnp.asarray(dist))
    ref = dict(
        ll=np.asarray(j_hmm.forward_loglik(*args_j)),
        post=[np.asarray(x) for x in j_hmm.posteriors(
            args_j[2], args_j[3], args_j[0], args_j[1])],
        vag=[np.asarray(x) for x in j_hmm.loglik_value_and_grad(*args_j)],
    )
    return dict(gl=np.transpose(gl, (1, 0, 2)), freq=freq, dist=dist, F=F,
                alpha=alpha, e=e, ref=ref)


def _port(case):
    return _t(case["F"]), _t(case["alpha"]), _t(case["e"]), _t(case["dist"])


def test_geometry():
    assert t_hmm.log_geometry(S, N) == (34, 12)
    for S_, C in ((1, 1), (31, 8), (397, 7), (1_000_000, 100),
                  (200_003, 2_000), (5, 10_000)):
        bs, nb = t_hmm.log_geometry(S_, C)
        assert nb * bs >= S_ and (nb - 1) * bs < S_  # no empty block
        assert nb == 1 or bs >= t_hmm.LOG_MIN_BS
        assert nb * C <= t_hmm.LOG_LANES_TARGET or nb == 1
    # the scan path's and the restart path's shapes fill one wave of the
    # lane kernels' resident slots
    assert t_hmm.log_geometry(1_000_000, 100) == (1185, 844)
    assert t_hmm.log_geometry(200_003, 2_000) == (4762, 42)


def test_forward_loglik_matches_jax(case):
    F, a, e, d = _port(case)
    ll = t_hmm.forward_loglik(F, a, e, d)
    observed("log forward_loglik", ll, case["ref"]["ll"])
    np.testing.assert_allclose(ll.numpy(), case["ref"]["ll"], rtol=LL_RTOL)


def test_posteriors_matches_jax(case):
    F, a, e, d = _port(case)
    p, ll_f, ll_b = t_hmm.posteriors(e, d, F, a)
    pj, lfj, lbj = case["ref"]["post"]
    observed("log posteriors p_ibd", p, pj)
    assert p.shape == (S, N) and p.dtype == torch.float64
    np.testing.assert_allclose(ll_f.numpy(), lfj, rtol=LL_RTOL)
    # ll_b folds in site 0's emission and log q (the sentinel step), so
    # it is the backward total the Fw/Bw check compares, not ll_f again
    np.testing.assert_allclose(ll_b.numpy(), lbj, rtol=LL_RTOL)
    assert not torch.equal(ll_f, ll_b)
    np.testing.assert_allclose(p.numpy(), pj, rtol=0, atol=P_ATOL)


def test_loglik_value_and_grad_matches_jax(case):
    F, a, e, d = _port(case)
    L, gF, ga = t_hmm.loglik_value_and_grad(F, a, e, d)
    Lj, gFj, gaj = case["ref"]["vag"]
    observed("log value_and_grad dL/dF", gF, gFj)
    observed("log value_and_grad dL/dalpha", ga, gaj)
    np.testing.assert_allclose(L.numpy(), Lj, rtol=LL_RTOL)
    np.testing.assert_allclose(gF.numpy(), gFj, rtol=G_RTOL)
    np.testing.assert_allclose(ga.numpy(), gaj, rtol=G_RTOL)


def test_plain_kernels_against_site_oracle(case):
    """The three plain versions against the per-site loops: the block
    products' rows are forward runs from a unit vector, the walks give
    the oracle's values at the block boundaries, the sweep its
    posterior and gradient."""
    F, a, e, d = _port(case)
    bs, nb = t_hmm.log_geometry(S, N)
    A = t_hmm.log_block_transfer(e, d, F, a, bs, nb)
    assert A.shape == (nb, N, 2, 2)
    fw, ll = t_hmm.forward(e, d, F, a)
    bw, ll_b = t_hmm.backward(e, d, F, a)
    fw_in, bw_out, lf_k, lb_k = t_hmm.log_combine(A, F)
    np.testing.assert_allclose(lf_k.numpy(), ll.numpy(), rtol=1e-13)
    np.testing.assert_allclose(lb_k.numpy(), ll_b.numpy(), rtol=1e-13)
    # block b's entry is fw at site b * bs - 1; its exit bw at its last site
    np.testing.assert_allclose(fw_in[1:].numpy(),
                               fw[bs - 1:(nb - 1) * bs:bs].numpy(),
                               rtol=1e-13)
    last = [min(S, (b + 1) * bs) - 1 for b in range(nb)]
    np.testing.assert_allclose(bw_out.numpy(), bw[last].numpy(), rtol=1e-13,
                               atol=1e-13)
    # block 1's product applied to its entry vector is fw at its end
    v = fw_in[1]
    end = torch.logsumexp(v[:, :, None] + A[1], dim=1)
    np.testing.assert_allclose(end.numpy(), fw[2 * bs - 1].numpy(),
                               rtol=1e-13)
    p = t_hmm.log_sweep(e, d, F, a, fw_in, bw_out, lf_k, bs)
    p_s, _, _ = t_hmm.posteriors_sites(e, d, F, a)
    np.testing.assert_allclose(p.numpy(), p_s.numpy(), rtol=0, atol=1e-12)
    g = t_hmm.log_sweep(e, d, F, a, fw_in, bw_out, lf_k, bs, grad=True)
    assert g.shape == (nb, N, 2)
    _, gF_s, ga_s = t_hmm.loglik_value_and_grad_sites(F, a, e, d)
    np.testing.assert_allclose(g.sum(0)[:, 0].numpy(), gF_s.numpy(),
                               rtol=1e-11)
    np.testing.assert_allclose(g.sum(0)[:, 1].numpy(), ga_s.numpy(),
                               rtol=1e-11)


def test_pad_sites_are_exact_no_ops(case):
    """A site at distance 0 with emissions 0 is the identity in log space
    (x = 1: log transitions 0 on the diagonal, -inf off it): appended to
    the chain it changes no forward or backward value by a bit. The plain
    versions pad every ragged last block with such sites; the kernels
    stop at the last real site."""
    F, a, e, d = _port(case)
    e2 = torch.cat([e, torch.zeros((1, N, 2), dtype=e.dtype)])
    d2 = torch.cat([d, torch.zeros(1, dtype=d.dtype)])
    fw, ll = t_hmm.forward(e, d, F, a)
    fw2, ll2 = t_hmm.forward(e2, d2, F, a)
    assert torch.equal(fw2[:S], fw) and torch.equal(fw2[S], fw[S - 1])
    assert torch.equal(ll2, ll)
    bw, lb = t_hmm.backward(e, d, F, a)
    bw2, lb2 = t_hmm.backward(e2, d2, F, a)
    assert torch.equal(bw2[:S], bw) and torch.equal(lb2, lb)
    # so a chain whose geometry pads its last block gives the oracle's
    # totals to float64 rounding, whatever the number of pads
    for S_ in (S, S - 5):
        bs, nb = t_hmm.log_geometry(S_, N)
        ll_k = t_hmm.forward_loglik(F, a, e[:S_], d[:S_])
        np.testing.assert_allclose(
            ll_k.numpy(), t_hmm.forward(e[:S_], d[:S_], F, a)[1].numpy(),
            rtol=1e-13)


def test_est_maf_log_matches_jax(case):
    """ops/maf.est_maf in log space without macro (maf_log's plain
    version) on a posterior of the chain, against the JAX exact damped
    fixed point (linear=False); also on a replicate's columns of a
    flattened posterior, read as a strided view, as the flattened scan
    tier reads them."""
    gl = case["gl"]
    p = np.clip(case["ref"]["post"][0], 0.0, 1.0)
    want = np.asarray(j_maf.est_maf(jnp.asarray(gl), jnp.asarray(p)))
    cuda_lib.reset_counts()
    got = t_maf.est_maf(_t(gl), _t(p)).numpy()
    assert cuda_lib.PLAIN_CALLS["maf_log"] == 1
    rel = np.abs(got - want) / np.abs(want)
    off = int((rel > MAF_RTOL).sum())
    print(f"observed est_maf log: max rel diff {rel.max():.3g}, sites "
          f"stopping at another pass {off} of {S}")
    assert off <= 1 and float(np.abs(got - want).max()) < 2e-5
    np.testing.assert_allclose(got[rel <= MAF_RTOL], want[rel <= MAF_RTOL],
                               rtol=MAF_RTOL)
    flat = torch.cat([_t(p) * 0.5, _t(p)], dim=1)  # replicate 1 of R = 2
    got2 = t_maf.est_maf(_t(gl), flat[:, N:])
    assert torch.equal(got2, torch.as_tensor(got))


def test_maf_log_geometry_covers_every_individual():
    """maf_log's segments (ops/maf.maf_log_geometry): lane s of a site's
    G lanes holds individuals s, s + G, ..., C of them, which covers every
    individual exactly once and fills at least 90% of the lane slots; a
    warp's cells fit the shared memory of a CTA. One N for each segment
    width the scan path's shapes and chip_smoke.py's use."""
    for N, G in ((20, 4), (33, 4), (100, 8), (130, 16), (1000, 32)):
        g, C = t_maf.maf_log_geometry(N)
        assert (g, C) == (G, -(-N // G))
        cells = [s + G * k for s in range(G) for k in range(C)
                 if s + G * k < N]
        assert sorted(cells) == list(range(N))
        assert N / (G * C) >= t_maf.MAF_LOG_FILL
        for esz in (8, 4):
            g2, C2, warps, smem = t_maf.maf_log_launch(N, esz)
            assert (g2, C2) == (G, C) and 1 <= warps <= 8
            assert smem == warps * 128 * C * esz <= 227 * 1024
    # past the shared memory a warp may hold, the cells are read from
    # device memory, one site a warp
    assert t_maf.maf_log_launch(4000, 8) == (32, 125, 8, 0)


def _logsum2_one_exp(a, b):
    """csrc/log_common.cuh's log_sum2 in torch: the term equal to the
    maximum is 1 + (m - m), not exp(0)."""
    m = torch.maximum(a, b)
    e = torch.exp(torch.where(a == m, b, a) - m)
    return _guard_ninf(torch.log(1.0 + (m - m) + e) + m, m)


def _logsum3_one_exp(a, b, c):
    """log_common.cuh's log_sum3 in torch: the first term equal to the
    maximum is 1 + (m - m), the other two exps, each in its place."""
    m = torch.maximum(torch.maximum(a, b), c)
    one = 1.0 + (m - m)
    am = a == m
    abm = am | (b == m)
    ex = torch.exp(torch.where(am, b, a) - m)
    ey = torch.exp(torch.where(abm, c, b) - m)
    s = torch.where(abm, (one + ex) + ey, (ex + ey) + one)
    return _guard_ninf(torch.log(s) + m, m)


def _guard_ninf(out, m):
    return torch.where(torch.isneginf(m), torch.full_like(out, -torch.inf),
                       out)


def _same_bits(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int64), b[~nan].view(torch.int64))


def test_one_exp_logsum_forms_equal_ops_logsum_bit_for_bit():
    """The maximum term's exp(x - m) is exp(+0.0) == 1.0 for a finite m,
    so the kernels' one-exp-fewer logsum2 / logsum3 give ops/logsum's
    bits on every input: every triple of edge values (signed zeros, +-1,
    +-inf, NaN, a subnormal, exp's ends, the largest float64), ties, and
    random arguments at gaps from 1e-12 to 1e3, in float64."""
    from ngsf_hmm_tpu_torch.ops import logsum as t_logsum

    assert torch.exp(torch.tensor([0.0, -0.0], dtype=torch.float64)).eq(
        1.0).all()
    edge = torch.tensor([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan,
                         5e-324, -745.2, 709.8, 1.7e308, -1.7e308],
                        dtype=torch.float64)
    k = edge.numel()
    idx = torch.stack(torch.meshgrid(*(torch.arange(k),) * 3,
                                     indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(43)
    n = 20_000
    x = rng.normal(0, 50, (n, 1)) + rng.normal(0, 1, (n, 3)) * 10.0 ** (
        rng.integers(-12, 4, (n, 3)))
    x[: n // 8, 1] = x[: n // 8, 0]  # ties
    x[n // 8: n // 4, 2] = x[n // 8: n // 4, 0] - 1e6  # one far below
    t = torch.cat([edge[idx], torch.as_tensor(x)])
    a, b, c = t.unbind(1)
    assert _same_bits(_logsum2_one_exp(a, b), t_logsum.logsum2(a, b))
    assert _same_bits(_logsum3_one_exp(a, b, c), t_logsum.logsum3(a, b, c))


def test_log_sweep_parks_only_within_its_share():
    """The sweep keeps the transitions in its scratch only while the
    scratch takes at most LOG_PARK_SHARE of the free memory: the scan and
    scan_restart shapes on an empty 80 GB card do, a card already nearly
    full computes them again."""
    gib = 2**30
    share = t_hmm.LOG_PARK_SHARE
    for S_, C, grad in ((1_000_000, 100, True), (200_003, 2_000, True),
                        (200_003, 2_000, False)):
        need = S_ * C * 8 * (6 if grad else 4)
        assert t_hmm.log_sweep_parks(S_, C, grad, 79 * gib)
        assert t_hmm.log_sweep_parks(S_, C, grad, need / share)
        assert not t_hmm.log_sweep_parks(S_, C, grad, need / share - 1)
    # the grad scratch is 1.5 times the posterior one
    free = 200_003 * 2_000 * 8 * 5 / share
    assert t_hmm.log_sweep_parks(200_003, 2_000, False, free)
    assert not t_hmm.log_sweep_parks(200_003, 2_000, True, free)


def test_plain_calls_counted_under_the_kernel_names(case):
    F, a, e, d = _port(case)
    cuda_lib.reset_counts()
    t_hmm.posteriors(e, d, F, a)
    t_hmm.loglik_value_and_grad(F, a, e, d)
    t_hmm.forward_loglik(F, a, e, d)
    assert dict(cuda_lib.PLAIN_CALLS) == {
        "log_block_transfer": 3, "log_combine": 3, "log_sweep": 2}
    assert not cuda_lib.LAUNCHES


def test_entry_points_match_csrc():
    """The ctypes signatures of the scan tier's exports against their
    declarations in csrc/ (pointer and integer arguments in order)."""
    src = "".join((cuda_lib.CSRC / f).read_text()
                  for f in ("log_chain.cu", "maf_log.cu"))
    assert {"log_chain.cu", "maf_log.cu"} <= set(cuda_lib.SOURCES)
    assert "log_common.cuh" in cuda_lib.HEADERS
    names = ("ngsf_log_block_transfer", "ngsf_log_combine",
             "ngsf_log_sweep", "ngsf_maf_log_f64", "ngsf_maf_log_f32")
    kinds = {cuda_lib._P: "p", cuda_lib._I: "i", cuda_lib._L: "l"}
    for name in names:
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        want = "".join(
            "p" if "*" in arg else ("l" if "long long" in arg else "i")
            for arg in m.group(1).split(","))
        got = "".join(kinds[t] for t in cuda_lib._SIGNATURES[name])
        assert got == want, name
