"""The scan tier's block products and walks at their edges (CPU, float64):
the plain versions of log_block_transfer (a block's 2x2 product in
linear float64, an exponent an entry) and log_combine (two levels: chunk
products, walks over the chunks, reruns inside them) of
ngsf_hmm_tpu_torch.models.hmm, csrc/log_chain.cu, against the per-site
log-space oracle loops and the JAX package's float64 tier.

Inputs: columns with F = 0, F = 1 and F = 1e-300 (transitions below the
least normal float64), -inf emissions of one state and of both, a site
whose emission gap is 800 nats, blocks whose row entries drift more than
745 nats apart, a decay below the least normal float64, chromosome breaks,
sites at distance 0 and a block of 1,200 sites given explicitly.

Tolerances: against the per-site oracle (the same steps in the log
semiring, another association) A's rows, fw_in, bw_out, ll_f and ll_b at
rtol 1e-13; against the JAX float64 tier the gates of
tests/test_torch_log_chain.py (ll rtol 1e-10, p_ibd atol 1e-10, gradients
rtol 1e-9).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ngsf_hmm_tpu.models import hmm as j_hmm
from test_torch_maf import observed
from ngsf_hmm_tpu_torch.models import hmm as t_hmm
from ngsf_hmm_tpu_torch.ops.logsum import logsum2
from ngsf_hmm_tpu_torch.utils import cuda_lib

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

ORACLE_RTOL = 1e-13
LL_RTOL, P_ATOL, G_RTOL = 1e-10, 1e-10, 1e-9
NINF = -np.inf


def _case(seed, S, N, breaks=()):
    """Random log emissions in (-12, 0), distances, F and alpha."""
    rng = np.random.default_rng(seed)
    e = np.log(rng.uniform(1e-5, 1.0, (S, N, 2)))
    dist = rng.uniform(0.001, 0.3, S)
    dist[0] = 1.5
    dist[list(breaks)] = np.inf
    F = rng.uniform(0.05, 0.9, N)
    alpha = rng.uniform(0.01, 0.5, N)
    return dict(e=e, dist=dist, F=F, alpha=alpha)


def _edges():
    """S = 301, N = 6: F = 0, 1 and 1e-300 in columns 0-2, -inf emissions,
    a site at distance 0, breaks, a decay of exp(-720) in column 1, an
    emission gap of 800 nats at one site."""
    c = _case(51, 301, 6, breaks=(97, 211))
    e, dist, F, alpha = c["e"], c["dist"], c["F"], c["alpha"]
    F[:3] = (0.0, 1.0, 1e-300)
    dist[40] = dist[41] = 0.0
    dist[150] = 2.0
    alpha[1] = 360.0  # x = exp(-720) at site 150: subnormal
    e[10:14, 3, 1] = NINF  # state 1 impossible for four sites
    e[60, 4, 0] = NINF
    e[120, 5, :] = NINF  # both: the column's chain is -inf past it
    e[180, 3, 0] = e[180, 3, 1] - 800.0  # one site's gap past exp's range
    return c


def _gap():
    """S = 240, N = 3, F = 0 in column 0, 1 in column 1: state 1's mass
    (state 0's in column 1) decays by x times a factor about e^-25 a site
    while the other state's is refreshed, so a block's row entries drift
    more than 745 nats apart and stay finite."""
    c = _case(53, 240, 3)
    c["F"][:2] = (0.0, 1.0)
    c["e"][:, 0, 1] = c["e"][:, 0, 0] - 25.0
    c["e"][:, 1, 0] = c["e"][:, 1, 1] - 25.0
    c["e"][:, 2, 1] = c["e"][:, 2, 0] - 25.0
    return c


CASES = {"edges": (_edges, 24), "gap": (_gap, 120),
         "long": (lambda: _case(57, 2_400, 4, breaks=(1_500,)), 1_200)}


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _port(c):
    return _t(c["e"]), _t(c["dist"]), _t(c["F"]), _t(c["alpha"])


def _rows_oracle(e, d, F, a, s0, s1):
    """The per-site log-space forward recursion over sites s0 .. s1 - 1
    from the unit vectors: [C, 2, 2], row k from e_k."""
    C = F.shape[0]
    zero = torch.zeros(C, dtype=torch.float64)
    ninf = torch.full_like(zero, NINF)
    rows = []
    for v0, v1 in ((zero, ninf), (ninf, zero)):
        for s in range(s0, s1):
            t = t_hmm._log_trans_elems(F, a, d[s:s + 1])
            v0, v1 = t_hmm._log_step(v0, v1, t, e[s, :, 0], e[s, :, 1])
        rows.append(torch.stack([v0, v1], -1))
    return torch.stack(rows, 1)


def _assert_close(got, want, rtol, what):
    observed(what, np.nan_to_num(got.numpy(), neginf=0.0),
             np.nan_to_num(want.numpy(), neginf=0.0))
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=0, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_block_rows_against_site_oracle(name):
    """Every block's product row for row against the log-space forward
    recursion from the unit vectors, at rtol 1e-13, -inf where it is
    -inf; the gap case's rows hold entries more than 745 nats apart (a
    shared exponent would flush the smaller one)."""
    make, bs = CASES[name]
    e, d, F, a = _port(make())
    S = e.shape[0]
    nb = -(-S // bs)
    A = t_hmm._log_block_transfer_plain(e, d, F, a, bs, nb)
    want = torch.stack([_rows_oracle(e, d, F, a, b * bs,
                                     min(S, (b + 1) * bs))
                        for b in range(nb)])
    assert torch.equal(torch.isneginf(A), torch.isneginf(want))
    _assert_close(A, want, ORACLE_RTOL, f"{name}: A rows")
    fin = torch.isfinite(want)
    gap = (want[..., 0] - want[..., 1]).abs()
    gap = gap[fin[..., 0] & fin[..., 1]]
    print(f"observed {name}: widest finite gap in a row {gap.max():.1f}")
    if name == "gap":
        assert float(gap.max()) > 745.0
    if name == "edges":  # F = 0 and 1: the unreachable entries stay -inf
        assert torch.isneginf(A[:, 0, 0, 1]).all()
        assert torch.isneginf(A[:, 1, 1, 0]).all()


def _serial_walks(A, F):
    """One walk over all nb products a direction (the pre-chunk order)."""
    lq = torch.log(torch.stack([1.0 - F, F], -1))
    fw, bw = torch.empty_like(A[..., 0]), torch.empty_like(A[..., 0])
    v0, v1 = lq[:, 0], lq[:, 1]
    for b in range(A.shape[0]):
        fw[b, :, 0], fw[b, :, 1] = v0, v1
        v0, v1 = t_hmm._lvm(v0, v1, A[b])
    w0 = w1 = torch.zeros_like(v0)
    for b in range(A.shape[0] - 1, -1, -1):
        bw[b, :, 0], bw[b, :, 1] = w0, w1
        w0, w1 = t_hmm._lmv(A[b], w0, w1)
    return fw, bw, logsum2(v0, v1), logsum2(w0 + lq[:, 0], w1 + lq[:, 1])


@pytest.fixture(scope="module")
def edges():
    c = _edges()
    e, d, F, a = _port(c)
    bs = 24
    nb = -(-e.shape[0] // bs)
    A = t_hmm._log_block_transfer_plain(e, d, F, a, bs, nb)
    fw, _ = t_hmm.forward(e, d, F, a)
    bw, ll_b = t_hmm.backward(e, d, F, a)
    return dict(c=c, A=A, bs=bs, nb=nb, fw=fw, bw=bw, ll_b=ll_b)


@pytest.mark.parametrize("L", [1, 5, 13, None])
def test_combine_against_site_oracle(edges, L):
    """log_combine's plain version at chunk length 1 (nb chunks), 5 (a
    ragged last chunk of 3), nb (one chunk) and the chooser's: each
    block's entry vector is the forward value at the site before it, its
    exit vector the backward value at its last site, and ll_f, ll_b the
    oracle's totals."""
    e, d, F, a = _port(edges["c"])
    A, bs, nb = edges["A"], edges["bs"], edges["nb"]
    assert nb == 13
    L = t_hmm.log_combine_chunk_len(nb) if L is None else L
    fw_in, bw_out, ll_f, ll_b = t_hmm._log_combine_plain(A, F, L)
    S = e.shape[0]
    fw, bw = edges["fw"], edges["bw"]
    lq = torch.log(torch.stack([1.0 - F, F], -1))
    want_in = torch.cat([lq[None], fw[bs - 1:(nb - 1) * bs:bs]])
    last = [min(S, (b + 1) * bs) - 1 for b in range(nb)]
    _assert_close(fw_in, want_in, ORACLE_RTOL, f"L={L}: fw_in")
    _assert_close(bw_out, bw[last], ORACLE_RTOL, f"L={L}: bw_out")
    _assert_close(ll_f, torch.logsumexp(fw[-1], -1), ORACLE_RTOL,
                  f"L={L}: ll_f")
    _assert_close(ll_b, edges["ll_b"], ORACLE_RTOL, f"L={L}: ll_b")


def test_combine_ends_are_the_serial_walks(edges):
    """At chunk length 1 the chunk walks are the serial walks over the nb
    products, and at chunk length nb the reruns are: the same steps in
    the same order, so the same bits (the chooser's chunks in between
    associate otherwise)."""
    A, F = edges["A"], _t(edges["c"]["F"])
    fw, bw, lf, lb = _serial_walks(A, F)
    one = t_hmm._log_combine_plain(A, F, 1)
    for got, want in zip(one, (fw, bw, lf, lb)):
        assert torch.equal(got, want)
    whole = t_hmm._log_combine_plain(A, F, A.shape[0])
    assert torch.equal(whole[0], fw) and torch.equal(whole[1], bw)


def test_pad_sites_leave_the_linear_product_unchanged():
    """A pad site (d = 0, emissions 0) is an exact no-op of the linear
    chain: the transitions are the identity with exponent 0, the emission
    factors 1, the offset + 0. So a block padded by any number of them
    gives the unpadded block's bits, and so does a real site at distance
    0 with zero emissions in its middle."""
    e, d, F, a = _port(_edges())
    S = 90
    e, d = e[:S], d[:S]
    A = t_hmm._log_block_transfer_plain(e, d, F, a, S, 1)
    for pad in (1, 7):
        assert torch.equal(
            t_hmm._log_block_transfer_plain(e, d, F, a, S + pad, 1), A)
    mid = torch.cat([e[:45], torch.zeros((1,) + e.shape[1:],
                                         dtype=e.dtype), e[45:]])
    d_mid = torch.cat([d[:45], d.new_zeros(1), d[45:]])
    assert torch.equal(
        t_hmm._log_block_transfer_plain(mid, d_mid, F, a, S + 1, 1), A)


def test_chunk_len_fits_one_cta():
    """The chooser: about sqrt(nb) blocks a chunk (30 of 29 chunks at the
    scan path's nb = 844, 7 of 6 at scan_restart's 42), never more chunks
    than a CTA holds, for every nb log_geometry can give; the launch
    (log_combine_launch) gives a CTA tn columns of every chunk, within
    the kernel's thread bound, and covers every column."""
    assert t_hmm.log_combine_chunk_len(844) == 30
    assert t_hmm.log_combine_chunk_len(42) == 7
    assert t_hmm.log_combine_chunk_len(1) == 1
    top = cuda_lib.LOG_COMBINE_MAX_CHUNKS
    for nb in list(range(1, 300)) + [844, 4_096, 84_480, 300_000]:
        L = t_hmm.log_combine_chunk_len(nb)
        nc = -(-nb // L)
        assert 1 <= L <= nb and nc <= top
        assert (nc - 1) * L < nb  # no empty chunk
        if nb <= top * top:
            assert L * L >= nb and (L - 1) * (L - 1) < nb
        for C in (1, 100, 2_000):
            tn, threads, ctas = t_hmm.log_combine_launch(nb, C, L)
            assert 1 <= tn <= 32 and tn * nc <= top
            assert threads == 2 * tn * nc and ctas * tn >= C > (ctas - 1) * tn
    assert t_hmm.log_combine_launch(844, 100, 30) == (16, 928, 7)
    assert t_hmm.log_combine_launch(42, 2_000, 7) == (32, 384, 63)


def test_edge_columns_match_jax(edges):
    """The public chain functions on the edge case (F = 0, 1 and 1e-300,
    -inf emissions of one state, breaks, distance 0, a subnormal decay, an
    800-nat emission gap) against the JAX float64 tier at its gates.
    Column 5's chain is -inf past a site whose emissions are both -inf:
    the comparison takes the other five."""
    c = edges["c"]
    e, d, F, a = _port(c)
    keep = slice(0, 5)
    args_j = [jnp.asarray(c[k][..., :5] if k != "dist" else c[k])
              for k in ("F", "alpha", "e", "dist")]
    args_j[2] = jnp.asarray(c["e"][:, keep])
    ll_j = np.asarray(j_hmm.forward_loglik(*args_j))
    p_j, lf_j, lb_j = (np.asarray(x) for x in j_hmm.posteriors(
        args_j[2], args_j[3], args_j[0], args_j[1]))
    L_j, gF_j, ga_j = (np.asarray(x) for x in
                       j_hmm.loglik_value_and_grad(*args_j))
    ll = t_hmm.forward_loglik(F, a, e, d)
    assert torch.isneginf(ll[5])
    np.testing.assert_allclose(ll[keep].numpy(), ll_j, rtol=LL_RTOL)
    p, lf, lb = t_hmm.posteriors(e, d, F, a)
    observed("edges p_ibd", p[:, keep], p_j)
    np.testing.assert_allclose(lf[keep].numpy(), lf_j, rtol=LL_RTOL)
    np.testing.assert_allclose(lb[keep].numpy(), lb_j, rtol=LL_RTOL)
    np.testing.assert_allclose(p[:, keep].numpy(), p_j, rtol=0,
                               atol=P_ATOL)
    L, gF, ga = t_hmm.loglik_value_and_grad(F, a, e, d)
    np.testing.assert_allclose(L[keep].numpy(), L_j, rtol=LL_RTOL)
    fin = np.isfinite(gF_j) & np.isfinite(ga_j)
    assert fin[3:].all()
    observed("edges dL/dF", gF[keep].numpy()[fin], gF_j[fin])
    np.testing.assert_allclose(gF[keep].numpy()[fin], gF_j[fin],
                               rtol=G_RTOL)
    np.testing.assert_allclose(ga[keep].numpy()[fin], ga_j[fin],
                               rtol=G_RTOL)
