"""The float32 scan tier (--dtype float32 --kernel scan; CPU, the kernels'
plain versions): ngsf_hmm_tpu_torch.models.hmm's chain functions and one
em_iteration / run_em in float32, against the per-site oracle and the
JAX package's float32 and float64 tiers (models/hmm.py, em_iteration
with numerics "log").

The float32 block products (csrc/log_common.cuh, LxK<float>) keep their
own constants: exponent field and bias of float32, subnormal transitions
scaled by 2^24, a product 2^-26 of the other dropped, emission gaps past
-87 nats kept apart with a Cody-Waite reduction whose first step is exact
(tested here), gaps past -2^20 nats clamped as in float64. The walks and
log-likelihoods are carried in float64 (a deliberate difference: JAX
carries them in float32), so the port's float32 tier is nearer the
float64 tier than JAX's float32 is.

Tolerances (stated, each from the float32 rounding it allows):
  - block products against the float64 per-site oracle on the same
    (float32) inputs: |A - A_64| <= 4e-7 |A_64| + 2e-5, entries -inf
    exactly where the oracle's are;
  - posteriors against JAX float64: atol 2e-5 (the ROADMAP's float32
    gate); against JAX float32: within JAX float32's own distance to
    float64 plus 2e-5; and the port's float32 no farther from float64
    than JAX's float32 is (factor 1);
  - log-likelihoods rtol 1e-6 of JAX float64, gradients 1e-4 of the
    largest |gradient| (float32 block sums);
  - one em_iteration against the float64 tier from the same state: freq
    and e_prob atol 1e-5, p_ibd atol 2e-5, F and alpha atol 2e-3 + rtol
    1e-3 (test_torch_em_freq.py's optimizer gate), ind_lkl rtol 1e-6;
    against JAX float32: within JAX float32's own distance to the
    float64 iteration plus those gates, element by element;
  - run_em's Viterbi paths equal to the JAX Viterbi's on the same final
    float32 state.
"""

import contextlib
import io
import math
import os
from fractions import Fraction

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from ngsf_hmm_tpu.models import em as j_em
from ngsf_hmm_tpu.models import hmm as j_hmm
from test_torch_maf import observed
from ngsf_hmm_tpu_torch import convert
from ngsf_hmm_tpu_torch.models import em as t_em
from ngsf_hmm_tpu_torch.models import hmm as t_hmm

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

f32, f64 = torch.float32, torch.float64
NINF = -np.inf
A_RTOL, A_ATOL = 4e-7, 2e-5
P_ATOL = 2e-5
LL_RTOL, G_REL = 1e-6, 1e-4


def _edges32():
    """S = 400, N = 8 in float32's range: F = 0, 1 and 1e-40 (a subnormal
    float32) in columns 0-2; a decay of exp(-90) (subnormal in float32) at
    site 150 of column 0 (its T11 = x) and 1; emission gaps of 100 and 300
    nats (past -87) in column 3, one of 3e6 nats (past the -2^20 clamp)
    in column 4, which mixes with the other state there; -inf emissions of
    one state, a run of 30 sites at distance 0, chromosome breaks."""
    rng = np.random.default_rng(61)
    S, N = 400, 8
    e = np.log(rng.uniform(1e-4, 1.0, (S, N, 2)))
    dist = rng.uniform(0.001, 0.3, S)
    dist[0] = 1.5
    dist[[97, 301]] = np.inf
    dist[200:230] = 0.0
    F = rng.uniform(0.05, 0.9, N)
    alpha = rng.uniform(0.01, 0.5, N)
    F[:3] = (0.0, 1.0, 1e-40)
    alpha[:2] = 300.0
    dist[150] = 0.3  # alpha d = 90
    e[::9, 3, 1] = e[::9, 3, 0] - 100.0
    e[5::13, 3, 0] = e[5::13, 3, 1] - 300.0
    e[77, 4, 1] = e[77, 4, 0] - 3e6
    e[10:14, 5, 1] = NINF
    e[60, 6, 0] = NINF
    return [torch.as_tensor(x).to(f32) for x in (e, dist, F, alpha)]


def _rows_oracle64(e, d, F, a, s0, s1):
    """The per-site log-space forward recursion over sites s0 .. s1 - 1
    from the unit vectors, [C, 2, 2] (row k from e_k), in float64 on the
    float32 log transitions (a float32 decay may flush to 0 where a
    float64 one would not: that is the inputs' type, not the chain's)."""
    e = e.double()
    zero = torch.zeros(F.shape[0], dtype=f64)
    ninf = torch.full_like(zero, NINF)
    rows = []
    for v0, v1 in ((zero, ninf), (ninf, zero)):
        for s in range(s0, s1):
            t = [x.double() for x in
                 t_hmm._log_trans_elems(F, a, d[s:s + 1])]
            v0, v1 = t_hmm._log_step(v0, v1, t, e[s, :, 0], e[s, :, 1])
        rows.append(torch.stack([v0, v1], -1))
    return torch.stack(rows, 1)


@pytest.mark.parametrize("bs", [40, 400])
def test_block_products_f32_against_site_oracle(bs):
    """Every float32 block product against the float64 per-site oracle on
    the same inputs, on the float32 edge case, at blocks of 40 sites and
    one block of all 400: -inf exactly where the oracle's entries are,
    the rest within A_RTOL |A| + A_ATOL."""
    e, d, F, a = _edges32()
    S = e.shape[0]
    nb = -(-S // bs)
    A = t_hmm._log_block_transfer_plain(e, d, F, a, bs, nb)
    assert A.dtype == f32
    want = torch.stack([_rows_oracle64(e, d, F, a, b * bs,
                                       min(S, (b + 1) * bs))
                        for b in range(nb)])
    assert torch.equal(torch.isneginf(A), torch.isneginf(want))
    fin = torch.isfinite(want)
    got, w = A.double()[fin], want[fin]
    err = ((got - w).abs() - A_RTOL * w.abs()).max()
    observed(f"float32 A rows, blocks of {bs}", got, w)
    print(f"observed excess over {A_RTOL} |A|: {float(err):.3g}")
    assert float(err) <= A_ATOL
    # F = 0 and 1: the unreachable entries stay -inf
    assert torch.isneginf(A[:, 0, 0, 1]).all()
    assert torch.isneginf(A[:, 1, 1, 0]).all()


def test_f32_constants_and_exact_reduction():
    """LxK<float>'s constants against their definitions, and the
    Cody-Waite reduction's first step exact: for gaps from -87 nats to the
    -2^20 clamp, gc - j * hi formed in float64 (the plain version; the
    kernel's one fused multiply-add) equals the exact rational value and
    is a float32; exp(gc - j ln 2) 2^j is exp(gc) to float32 precision;
    gaps past the clamp count as -2^20 nats."""
    k = t_hmm._LX[f32]
    assert k.hi == float(np.float32(math.log(2)))
    assert k.lo == float(np.float32(math.log(2) - k.hi))
    assert k.inv_ln2 == float(np.float32(1 / math.log(2)))
    assert k.drop == 25 and k.sub == 24 and k.split == -87.0
    assert k.tiny == float(np.finfo(np.float32).tiny)
    # a term 2^-26 of the other (both in [1, 4)) is below half an ulp of 1
    assert np.float32(1.0) + np.float32(4 * 2.0 ** -(k.drop + 1)) == 1.0
    rng = np.random.default_rng(5)
    gc = np.concatenate([-np.logspace(np.log10(87.0), 20 * np.log10(2),
                                      4000), [-87.0001, -2.0 ** 20]])
    gc = torch.as_tensor(gc + rng.uniform(-0.5, 0.5, gc.size)).to(f32)
    gc = gc.clamp(-2.0 ** 20, -87.0)
    j = torch.trunc(gc * k.inv_ln2)
    r = gc.double() - j.double() * k.hi
    for g_, j_, r_ in zip(gc.tolist()[::97], j.tolist()[::97],
                          r.tolist()[::97]):
        exact = Fraction(g_) - Fraction(j_) * Fraction(k.hi)
        assert Fraction(r_) == exact
        assert float(np.float32(r_)) == r_  # a float32: the fma is exact
    assert float(r.abs().max()) < 1.0
    w = t_hmm._lx_reduce(gc, j)
    print(f"observed float32 reduction factors in [{float(w.min())}, "
          f"{float(w.max())}]")
    # about (1/2, 1]: j = trunc(gc / ln 2) rounded in float32 may be one
    # off near an integer (|gc / ln 2| up to 1.5e6, an ulp of 0.125)
    assert bool(((w > 0.45) & (w < 1.12)).all())
    rel = (torch.log(w.double()) + j.double() * math.log(2)
           - gc.double()).abs()
    observed("float32 reduction, log(w 2^j) - gap", rel, 0 * rel)
    assert float(rel.max()) < 4e-7 + 2e-9 * float(gc.abs().max())
    # past the clamp
    e0 = torch.tensor([0.0, 0.0], dtype=f32)
    e1 = torch.tensor([-3e6, -2.0 ** 20], dtype=f32)
    _, w2, j2 = t_hmm._lx_emissions(e0, e1)
    assert torch.equal(w2[0], w2[1]) and torch.equal(j2[0], j2[1])


def test_f32_log_likelihoods_are_float64_and_agree():
    """The float32 tier's walks run in float64 (log_combine): ll_f and
    ll_b are float64, agree with each other to float64 rounding over a
    long chain (the Fw/Bw check's 0.001 would not hold for float32 walks
    at 10^6 sites), and the float32 sweep's posteriors, on vectors taken
    relative to ll_f (_sweep_vectors), sum with the float64 tier's to
    float32 precision."""
    rng = np.random.default_rng(9)
    S, C = 6_000, 3
    e = torch.as_tensor(np.log(rng.uniform(1e-3, 1.0, (S, C, 2))))
    d = torch.as_tensor(rng.uniform(0.001, 0.1, S))
    F = torch.as_tensor(rng.uniform(0.1, 0.5, C))
    a = torch.as_tensor(rng.uniform(0.05, 0.3, C))
    p32, lf, lb = t_hmm.posteriors(e.float(), d.float(), F.float(),
                                   a.float())
    p64, lf64, _ = t_hmm.posteriors(e, d, F, a)
    assert p32.dtype == f32 and lf.dtype == lb.dtype == f64
    observed("float32 tier ll_f - ll_b", lf, lb)
    assert float((lf - lb).abs().max()) < 1e-9 * float(lf.abs().max())
    np.testing.assert_allclose(lf.numpy(), lf64.numpy(), rtol=LL_RTOL)
    observed("float32 tier p_ibd against float64", p32.double(), p64)
    assert float((p32.double() - p64).abs().max()) < 1e-4


def test_float32_geometry_and_scratch(monkeypatch):
    """The float32 tier's blocks are at most LOG_F32_MAX_BS sites (its
    sweep's rounding grows with the block: 128 sites at the scan and
    scan_restart shapes, where float64 runs 1,185 and 4,762); the chain
    functions use that geometry; the export suffix of each float type."""
    assert t_hmm.log_geometry(1_000_000, 100, f32) == (128, 7_813)
    assert t_hmm.log_geometry(200_003, 2_000, f32) == (128, 1_563)
    assert t_hmm.log_geometry(1_000_000, 100) == (1_185, 844)
    assert t_hmm.log_geometry(300, 6, f32) == t_hmm.log_geometry(300, 6)
    e, d, F, a = _edges32()
    monkeypatch.setattr(t_hmm, "LOG_F32_MAX_BS", 20)  # below bs 34 here
    calls = dict(t_hmm.PLAIN_CALLS)
    ll = t_hmm.forward_loglik(F, a, e, d)
    bs, nb = t_hmm.log_geometry(400, 8, f32)
    assert (bs, nb) == (20, 20)
    A = t_hmm._log_block_transfer_plain(e, d, F, a, bs, nb)
    assert torch.equal(ll, t_hmm.log_combine(A, F)[2])
    assert t_hmm.PLAIN_CALLS["log_block_transfer_f32"] == calls.get(
        "log_block_transfer_f32", 0) + 2
    assert t_hmm._sfx(f32) == "_f32" and t_hmm._sfx(f64) == ""
    with pytest.raises(TypeError):
        t_hmm._sfx(torch.bfloat16)


@pytest.fixture(scope="module")
def chain():
    rng = np.random.default_rng(71)
    S, N = 300, 6
    gl, freq, dist, F, alpha, e = oracle.random_case(rng, S=S, N=N,
                                                     chrom_break_every=113)
    c32 = [np.asarray(x, np.float32) for x in (e, dist, F, alpha)]
    return c32


def _jax(c, dt):
    e, d, F, a = (jnp.asarray(x.astype(dt)) for x in c)
    p, lf, lb = j_hmm.posteriors(e, d, F, a)
    L, gF, ga = j_hmm.loglik_value_and_grad(F, a, e, d)
    return [np.asarray(x, np.float64) for x in (p, lf, lb, L, gF, ga)]


def test_posteriors_f32_against_jax(chain):
    """posteriors in float32 against JAX float64 (the float32 gate) and
    JAX float32 (within its own distance to float64 plus the gate); the
    port's float32 no farther from float64 than JAX's float32 is."""
    e, d, F, a = (torch.as_tensor(x) for x in chain)
    p, lf, lb = t_hmm.posteriors(e, d, F, a)
    j32, j64 = _jax(chain, np.float32), _jax(chain, np.float64)
    d64 = np.abs(p.double().numpy() - j64[0]).max()
    dj = np.abs(j32[0] - j64[0]).max()
    print(f"observed float32 p_ibd: port - JAX f64 {d64:.3g}, JAX f32 - "
          f"JAX f64 {dj:.3g}, port - JAX f32 "
          f"{np.abs(p.double().numpy() - j32[0]).max():.3g}")
    assert d64 <= P_ATOL
    assert d64 <= 1.0 * dj
    np.testing.assert_allclose(p.double().numpy(), j32[0], rtol=0,
                               atol=dj + P_ATOL)
    np.testing.assert_allclose(lf.numpy(), j64[1], rtol=LL_RTOL)
    np.testing.assert_allclose(lb.numpy(), j64[2], rtol=LL_RTOL)


def test_loglik_value_and_grad_f32_against_jax(chain):
    """loglik_value_and_grad in float32 against JAX float64 (ll rtol
    1e-6, gradients 1e-4 of the largest) and no farther from it than JAX
    float32 is, by a factor 1 (ll) and 2 (gradients)."""
    e, d, F, a = (torch.as_tensor(x) for x in chain)
    L, gF, ga = t_hmm.loglik_value_and_grad(F, a, e, d)
    assert L.dtype == f64 and gF.dtype == ga.dtype == f32
    j32, j64 = _jax(chain, np.float32), _jax(chain, np.float64)
    np.testing.assert_allclose(L.numpy(), j64[3], rtol=LL_RTOL)
    assert np.abs(L.numpy() - j64[3]).max() <= np.abs(j32[3] - j64[3]).max()
    for got, k in ((gF, 4), (ga, 5)):
        err = np.abs(got.double().numpy() - j64[k]).max()
        err_j = np.abs(j32[k] - j64[k]).max()
        print(f"observed float32 gradient {k}: port {err:.3g}, JAX f32 "
              f"{err_j:.3g}")
        assert err <= G_REL * np.abs(j64[k]).max()
        assert err <= 2.0 * err_j + 1e-6


# the keywords JAX run_em passes to em_iteration on its first iteration
RUN_EM_KW = dict(freq_est=1, e_prob_calc=1, indF_fixed=False,
                 alpha_fixed=False, block_size=None, numerics="log",
                 gl_tiles=None, opt_memory=None, return_opt=True,
                 defer_emissions=False, defer_posteriors=False,
                 gl_bf16=False)
S, N = 300, 6


@pytest.fixture(scope="module")
def em_case():
    """A float32 init state of both packages from one set of inputs."""
    rng = np.random.default_rng(43)
    gl, _, dist, _, _, _ = oracle.random_case(rng, S=S, N=N,
                                              chrom_break_every=113)
    gl = np.ascontiguousarray(np.transpose(gl, (1, 0, 2))).astype(np.float32)
    dist = dist.astype(np.float32)
    freq = rng.uniform(0.05, 0.45, S).astype(np.float32)
    F = rng.uniform(0.05, 0.6, N).astype(np.float32)
    alpha = rng.uniform(0.01, 0.3, N).astype(np.float32)
    st_j = j_em.init_state(jnp.asarray(gl), jnp.asarray(freq),
                           jnp.asarray(F), jnp.asarray(alpha))
    arrays = {k: np.array(getattr(st_j, k)) for k in convert.STATE_FIELDS}
    assert arrays["e_prob"].dtype == np.float32
    return dict(gl=gl, dist=dist, st_j=st_j, arrays=arrays)


def test_em_iteration_f32_matches_jax(em_case):
    """One float32 em_iteration (freq_est 1, e_prob_calc 1) against the
    JAX package's float32 scan tier (the file's one em_iteration
    compilation) and against the float64 tier (the port's, which
    tests/test_torch_log_em.py holds to JAX float64 at rtol 1e-8) from
    the same state: within the float32 gates of the float64 iteration,
    and within JAX float32's own distance to it (elementwise) plus those
    gates of the JAX float32 iteration (JAX float32's gradient is 80
    times as far from float64 as the port's here, and one alpha ends
    0.021 from float64's, the port's 2.7e-4)."""
    c = em_case
    sj, stat_j, _ = j_em.em_iteration(jnp.asarray(c["gl"]),
                                      jnp.asarray(c["dist"]), c["st_j"],
                                      **RUN_EM_KW)
    st0 = convert.state_from_jax(c["arrays"], device="cpu")
    st, stat = t_em.em_iteration(torch.as_tensor(c["gl"]),
                                 torch.as_tensor(c["dist"]), st0)
    st64, _ = t_em.em_iteration(
        torch.as_tensor(c["gl"]).double(), torch.as_tensor(c["dist"]).double(),
        convert.state_from_jax(c["arrays"], device="cpu", dtype=f64))
    gates = dict(freq=(1e-5, 0), p_ibd=(P_ATOL, 0), e_prob=(1e-5, 0),
                 indF=(2e-3, 1e-3), alpha=(2e-3, 1e-3), ind_lkl=(0, 1e-6))
    for k, (atol, rtol) in gates.items():
        got = getattr(st, k)
        assert got.dtype == f32, k
        got = got.double().numpy()
        w64 = getattr(st64, k).numpy()
        wj = np.asarray(getattr(sj, k), np.float64)
        fin = np.isfinite(w64)
        assert np.array_equal(fin, np.isfinite(got)), k
        g, w, j = got[fin], w64[fin], wj[fin]
        print(f"observed float32 em_iteration {k}: port - float64 "
              f"{np.abs(g - w).max():.3g}, JAX f32 - float64 "
              f"{np.abs(j - w).max():.3g}, port - JAX f32 "
              f"{np.abs(g - j).max():.3g}")
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=k)
        assert (np.abs(g - j) <= np.abs(j - w) + atol + rtol * np.abs(w)
                ).all(), k
    # the float64 walks: Fw and Bw agree far inside lkl_check_tol
    assert float(stat.fwbw_maxdiff) < 1e-9


def test_run_em_f32_viterbi_and_cli(em_case, tmp_path):
    """run_em in float32 (min_iters 3): a float32 state throughout, its
    Viterbi path equal to the JAX float32 Viterbi's on the same final
    state; and the CLI's --dtype float32 (the scan tier) runs on the CPU."""
    c = em_case
    st0 = convert.state_from_jax(c["arrays"], device="cpu")
    res = t_em.run_em(c["gl"], c["dist"], st0,
                      t_em.EMOptions(min_iters=3, max_iters=4,
                                     min_epsilon=100.0, verbose=0),
                      device="cpu")
    assert res.n_iters == 3
    for k in convert.STATE_FIELDS:
        assert getattr(res.state, k).dtype == f32, k
    a = {k: jnp.asarray(v) for k, v in
         convert.state_to_jax(res.state).items()}
    path_j, _ = j_hmm.viterbi(a["e_prob"], jnp.asarray(c["dist"]), a["indF"],
                              a["alpha"], compat=True)
    assert np.array_equal(res.path, np.asarray(path_j))
    from ngsf_hmm_tpu_torch.cli import main

    rng = np.random.default_rng(3)
    geno = tmp_path / "in.geno"
    rng.dirichlet(np.ones(3), size=(60, 4)).astype("<f8").tofile(geno)
    pos = tmp_path / "in.pos"
    pos.write_text("".join(f"chr1\t{5000 * (s + 1)}\n" for s in range(60)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--geno", str(geno), "--pos", str(pos), "--n_ind", "4",
                   "--n_sites", "60", "--min_iters", "2", "--max_iters", "3",
                   "--out", str(tmp_path / "run"), "--device", "cpu",
                   "--dtype", "float32"])
    assert rc == 0 and "Final logLkl" in buf.getvalue()
    assert os.path.getsize(tmp_path / "run.geno") == 60 * 4 * 3 * 8
