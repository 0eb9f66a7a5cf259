"""The est_maf kernels of the port against the JAX package, on the CPU.

The plain versions of the four est_maf kernels (ngsf_hmm_tpu_torch/ops/
maf_kernels.py) are held against the Pallas kernels of
ngsf_hmm_tpu.ops.maf_pallas in interpret mode, float32, compared per site
([S] values after unpacking each side's layout); one em_iteration on the
slab route against the JAX em_iteration. Inputs come from numpy seeds.
ops/maf.py itself is held in tests/test_torch_maf.py.

Tolerances, with their reasons:
- kernel rows freq / num / den / cn / cd: 2e-5 of max(|x|, 1), `active`
  equal on every site (the 2e-5 gate the JAX package holds its kernels
  to). The derivative rows dcn / dcd: 5e-4 of max(|x|, 1): they sum
  cancelling terms, and the JAX kernel's approximate reciprocal (one
  Newton step) is about 1e-5 off per cell in interpret mode; against a
  float64 evaluation the port's rows are within 5e-6 (asserted) and
  the JAX kernel's dcd is 1.0e-4 off (printed).
- est_maf_slab / est_maf_exact freq: atol 2e-5 (tests/test_maf.py's gate).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ngsf_hmm_tpu.models import em as j_em
from ngsf_hmm_tpu.models import hmm_pallas as j_hp
from ngsf_hmm_tpu.ops import maf as j_maf
from ngsf_hmm_tpu.ops import maf_pallas as j_mp
from ngsf_hmm_tpu.ops.hwe import check_interv as j_check_interv
from ngsf_hmm_tpu_torch import convert
from ngsf_hmm_tpu_torch.models import em as t_em
from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
from ngsf_hmm_tpu_torch.ops import maf as t_maf
from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
from test_torch_maf import observed, realistic_gls, scaled_diff

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

ROWS = ("freq", "num", "den", "active", "cn", "cd", "dcn", "dcd")


# ---------------------------------------------------------------------------
# the slab kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _jax_sites(x, p2):
    """JAX per-site [bs_pad, nb_p] value -> [S]."""
    v = jnp.swapaxes(x, 0, 1)[: p2["nb"], : p2["bs"]]
    return np.asarray(v.reshape(-1)[: p2["S"]])


def _port_compact(vec, tp):
    """[S] -> the port's [bs, nb] per-site compact."""
    return hk.site_compact(torch.as_tensor(vec), tp["bs"], tp["nb"], 0.5)


@pytest.fixture(scope="module", params=[(700, 100), (500, 40)],
                ids=lambda sn: f"S{sn[0]}N{sn[1]}")
def slab_case(request):
    """One shape per macro schedule (N >= 96 and 32 <= N < 96), both with
    a ragged last block in the port's layout and a row with F == 1. The
    JAX side's pieces (kernel A, kernel B, the windows) are run here once
    on the JAX layout and unpacked to [S]."""
    S, N = request.param
    rng = np.random.default_rng(91 + N)
    gl = realistic_gls(rng, S, N).astype(np.float32)
    gl /= gl.sum(-1, keepdims=True)
    F = (rng.random((S, N)) * 0.9).astype(np.float32)
    F[5] = 1.0
    F[6, ::2] = 1.0
    K0, M = j_maf.macro_schedule(N)
    Ms = j_maf.macro_rounds(K0, M)

    p2 = j_hp.prepare_gl_inputs(jnp.asarray(gl), jnp.zeros(S))
    assert j_mp.slab_geom_ok(S, N)
    ps = j_hp.pack_sites2(jnp.asarray(F), p2)
    geo = (p2["C"], p2["nb_p"], p2["G"], N, p2["bs_pad"])
    st8 = j_mp._run_state_grad_slab(p2["g0"], p2["g2"], ps, *geo, K0)
    st = tuple(st8[:, k, :] for k in range(4))
    grads = tuple(st8[:, k, :] for k in range(4, 8))
    win1 = j_mp._virtual_window(st, grads, K0, Ms[0])
    s4 = j_mp._run_sums_grad_slab(p2["g0"], p2["g2"], ps,
                                  win1[0][:, None, :], *geo)
    # the last window crosses ITER_MAX: its final step is outside
    last0 = K0 + sum(Ms[:-1])
    win_last = j_mp._virtual_window(
        win1, tuple(s4[:, k, :] for k in range(4)), last0, Ms[-1])

    tp = hk.prepare_gl_inputs(torch.as_tensor(gl), torch.zeros(S))
    assert tp["bs"] * tp["nb"] > S  # ragged last block
    return dict(
        S=S, N=N, K0=K0, Ms=Ms, gl=gl, F=F, p2=p2, ps=ps, tp=tp,
        tps=hk.pack_sites2(torch.as_tensor(F), tp, 0.5),
        A={n: _jax_sites(st8[:, k, :], p2) for k, n in enumerate(ROWS)},
        win1=[_jax_sites(x, p2) for x in win1],
        B=[_jax_sites(s4[:, k, :], p2) for k in range(4)],
        last0=last0, win_last=[_jax_sites(x, p2) for x in win_last],
    )


def test_state_grad_plain_matches_pallas_kernel(slab_case):
    """_state_grad_plain against _run_state_grad_slab (interpret mode):
    rows at the tolerances of the module docstring, `active` equal on
    every site."""
    c = slab_case
    out = mk._k_maf_state_grad(c["tp"]["g0"], c["tp"]["g2"], c["tps"],
                               c["K0"])
    assert out.shape == (8, c["tp"]["bs"], c["tp"]["nb"])
    assert torch.isfinite(out).all()  # pad sites included
    for k, name in enumerate(ROWS):
        got = mk._site_vector(out[k], c["tp"]).numpy()
        if name == "active":
            assert np.array_equal(got, c["A"][name])
        else:
            tol = 5e-4 if name in ("dcn", "dcd") else 2e-5
            d = scaled_diff(got, c["A"][name])
            print(f"observed kernel A {name}: scaled diff {d:.3g}")
            assert d <= tol, name
    # which side is off where they differ most: the same formulas in
    # float64 (the plain version on float64 slabs)
    f64 = mk._state_grad_plain(c["tp"]["g0"].double(), c["tp"]["g2"].double(),
                               c["tps"].double(), c["K0"])
    for k, name in ((6, "dcn"), (7, "dcd")):
        ref = mk._site_vector(f64[k], c["tp"]).numpy()
        d_port = scaled_diff(mk._site_vector(out[k], c["tp"]).numpy(), ref)
        d_jax = scaled_diff(c["A"][name], ref)
        print(f"observed {name} against float64: port {d_port:.3g}, "
              f"Pallas kernel {d_jax:.3g}")
        assert d_port <= 5e-6


def test_sums_grad_plain_matches_pallas_kernel(slab_case):
    """_sums_grad_plain against _run_sums_grad_slab at the same freq (the
    JAX side's freq after the first window)."""
    c = slab_case
    fq = _port_compact(c["win1"][0], c["tp"])
    out = mk._k_maf_sums_grad(c["tp"]["g0"], c["tp"]["g2"], c["tps"], fq)
    for k, name in enumerate(("cn", "cd", "dcn", "dcd")):
        tol = 5e-4 if name in ("dcn", "dcd") else 2e-5
        got = mk._site_vector(out[k], c["tp"]).numpy()
        d = scaled_diff(got, c["B"][k])
        print(f"observed kernel B {name}: scaled diff {d:.3g}")
        assert d <= tol, name


def test_virtual_window_plain_matches_jax(slab_case):
    """_virtual_window_plain against maf_pallas._virtual_window from the
    same state and sums (the JAX side's, laid out for the port): the first
    window, and the last one, whose final step lies past ITER_MAX so that
    every site ends inactive. 2e-5 of max(|x|, 1); `active` equal."""
    c = slab_case
    tp = c["tp"]
    st = torch.stack([_port_compact(c["A"][n], tp) for n in ROWS[:4]])
    grads = torch.stack([_port_compact(c["A"][n], tp) for n in ROWS[4:]])
    out = mk._k_maf_window(st, grads, c["K0"], c["Ms"][0])
    for k in range(4):
        got = mk._site_vector(out[k], tp).numpy()
        assert scaled_diff(got, c["win1"][k]) <= 2e-5, ROWS[k]
    assert np.array_equal(mk._site_vector(out[3], tp).numpy(), c["win1"][3])

    st = torch.stack([_port_compact(x, tp) for x in c["win1"]])
    grads = torch.stack([_port_compact(x, tp) for x in c["B"]])
    out = mk._k_maf_window(st, grads, c["last0"], c["Ms"][-1])
    for k in range(3):
        got = mk._site_vector(out[k], tp).numpy()
        assert scaled_diff(got, c["win_last"][k]) <= 2e-5, ROWS[k]
    assert c["last0"] + c["Ms"][-1] > 100
    assert not mk._site_vector(out[3], tp).any()
    assert not c["win_last"][3].any()


def test_est_maf_slab_matches_jax(slab_case):
    """est_maf_slab against maf_pallas.est_maf_slab and against JAX
    est_maf(linear=True, macro=True) on the [S, N] arrays: freq [S], atol
    2e-5 each; no pad value reaches the result."""
    c = slab_case
    got = mk.est_maf_slab(c["tp"], c["tps"])
    assert got.shape == (c["S"],) and got.dtype == torch.float32
    assert float(got.max()) <= 1.0
    want = np.asarray(j_mp.est_maf_slab(c["p2"], c["ps"], macro=True))
    observed("est_maf_slab vs maf_pallas.est_maf_slab", got, want)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    xla = np.asarray(j_maf.est_maf(jnp.asarray(c["gl"]), jnp.asarray(c["F"]),
                                   linear=True, macro=True))
    observed("est_maf_slab vs est_maf(linear, macro)", got, xla)
    np.testing.assert_allclose(got.numpy(), xla, atol=2e-5)


def test_est_maf_slab_needs_a_schedule(slab_case):
    c = slab_case
    tp = hk.prepare_gl_inputs(torch.as_tensor(c["gl"][:, :8]),
                              torch.zeros(c["S"]))
    with pytest.raises(ValueError, match="macro schedule"):
        mk.est_maf_slab(tp, hk.pack_sites2(torch.as_tensor(c["F"][:, :8]),
                                           tp))


# ---------------------------------------------------------------------------
# the exact fixed point
# ---------------------------------------------------------------------------


def test_est_maf_exact_matches_pallas_kernel():
    """est_maf_exact (snap=True on the raw posterior) against
    est_maf_pallas(prepare_gl_tiles(gl), check_interv(p), S, macro=True),
    which below 32 individuals runs the exact kernel _run: atol 2e-5.
    The posterior holds values within EPSILON of 0 and 1, which only the
    snap makes equal on both sides. snap=False reads them as they are."""
    rng = np.random.default_rng(5)
    S, N = 333, 7
    raw = rng.random((S, N, 3)) + 1e-4
    gl = (raw / raw.sum(-1, keepdims=True)).astype(np.float32)
    p = rng.random((S, N)).astype(np.float32)
    p[10] = 1.0 - 3e-6  # snapped to 1: the het floor engages
    p[11] = 4e-6
    p[12, :3] = 1.0
    tp = hk.prepare_gl_inputs(torch.as_tensor(gl), torch.zeros(S))
    tps = hk.pack_sites2(torch.as_tensor(p), tp, 0.5)
    got = mk.est_maf_exact(tp, tps, snap=True)
    assert got.shape == (S,) and got.dtype == torch.float32

    p_snap = j_check_interv(jnp.asarray(p))
    want = np.asarray(j_mp.est_maf_pallas(
        j_mp.prepare_gl_tiles(jnp.asarray(gl)), p_snap, S, macro=True))
    observed("est_maf_exact vs est_maf_pallas (_run)", got, want)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    xla = np.asarray(j_maf.est_maf(jnp.asarray(gl), p_snap, linear=True))
    np.testing.assert_allclose(got.numpy(), xla, atol=2e-5)

    unsnapped = mk.est_maf_exact(tp, tps, snap=False)
    own = t_maf.est_maf(torch.as_tensor(gl), torch.as_tensor(p), linear=True)
    np.testing.assert_allclose(unsnapped.numpy(), own.numpy(), atol=2e-5)
    assert float((unsnapped - got)[10].abs()) > 0  # the snap matters there


def test_est_maf_exact_het_certain_at_full_ibd():
    """A heterozygote-certain likelihood at p_ibd == 1 must not give NaN
    (calc_HWE's F == 1 het floor, gen_func.cpp:946-956): the case of
    tests/test_maf.py::test_est_maf_pallas_het_certain_at_full_ibd, finite
    and within 2e-6 of JAX est_maf(linear=True); the slab kernels' plain
    versions stay finite on it too."""
    S, N = 8, 3
    gl = np.full((S, N, 3), 1.0 / 3, np.float32)
    gl[2, 1] = [0.0, 1.0, 0.0]
    p = np.zeros((S, N), np.float32)
    p[2, :] = 1.0
    tp = hk.prepare_gl_inputs(torch.as_tensor(gl), torch.zeros(S), bs=4)
    tps = hk.pack_sites2(torch.as_tensor(p), tp)
    got = mk.est_maf_exact(tp, tps).numpy()
    assert np.isfinite(got).all()
    want = np.asarray(j_maf.est_maf(jnp.asarray(gl), jnp.asarray(p),
                                    linear=True))
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert torch.isfinite(mk.est_maf_slab(tp, tps, macro=(8, (12,)))).all()


# ---------------------------------------------------------------------------
# one EM iteration on the slab route
# ---------------------------------------------------------------------------


def test_em_iteration_slab_route_matches_jax():
    """One em_iteration with freq_est 1 at N = 40 (the slab route: macro
    schedule (16, (8, 16, 32, 29))) against JAX em_iteration(
    numerics="pallas") from the same entering state: freq atol 2e-5, p_ibd
    atol 1e-3, e_prob atol 1e-3 on finite entries. indF and alpha are held
    fixed on both sides: within an iteration the (F, alpha) M-step and the
    freq M-step both read the E-step's output and nothing of each other,
    the (F, alpha) M-step is held against JAX in tests/test_torch_em*.py,
    and leaving L-BFGS out of the JAX side's jit saves 14 s of a test run
    that sits at its time limit. The freq also equals est_maf_slab on the
    port's own E-step slab (wiring), and with defer_emissions the stale
    e_prob passes through."""
    rng = np.random.default_rng(402)
    S, N = 300, 40
    gl = np.log(realistic_gls(rng, S, N)).astype(np.float32)
    dist = np.full(S, 1e-5, np.float32)
    dist[150] = np.inf
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    st_j = j_em.init_state(jnp.asarray(gl), f32(np.full(S, 0.2)),
                           f32(np.full(N, 0.3)), f32(np.full(N, 0.05)))
    arrays = {k: np.array(getattr(st_j, k)) for k in convert.STATE_FIELDS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NGSF_PALLAS_R", "8")  # short interpret-mode trace
        sj, _ = j_em.em_iteration(jnp.asarray(gl), f32(dist), st_j,
                                  numerics="pallas", indF_fixed=True,
                                  alpha_fixed=True)
    st_t = convert.state_from_jax(arrays, device="cpu")
    gl_t, dist_t = torch.as_tensor(gl), torch.as_tensor(dist)
    fixed = dict(freq_est=1, indF_fixed=True, alpha_fixed=True,
                 numerics="pallas")
    st, stats = t_em.em_iteration(gl_t, dist_t, st_t, **fixed)
    assert float(stats.fwbw_maxdiff) < 1e-3 and stats.opt_iters == 0
    observed("em_iteration slab route freq", st.freq, sj.freq)
    np.testing.assert_allclose(st.freq.numpy(), np.asarray(sj.freq),
                               atol=2e-5)
    assert torch.equal(st.indF, st_t.indF) and torch.equal(st.alpha,
                                                           st_t.alpha)
    np.testing.assert_allclose(st.p_ibd.numpy(), np.asarray(sj.p_ibd),
                               atol=1e-3)
    ej = np.asarray(sj.e_prob)
    fin = np.isfinite(ej)
    np.testing.assert_allclose(st.e_prob.numpy()[fin], ej[fin], atol=1e-3)

    prep = hk.prepare_gl_inputs(torch.exp(gl_t), dist_t)
    _, _, _, slab = hk.posteriors_fused(
        st_t.indF, st_t.alpha, prep, hk.freq_compact(st_t.freq, prep),
        return_slab=True)
    assert torch.equal(st.freq, mk.est_maf_slab(prep, slab))
    lazy, _ = t_em.em_iteration(gl_t, dist_t, st_t, defer_emissions=True,
                                defer_posteriors=True, **fixed)
    assert torch.equal(lazy.freq, st.freq)
    assert lazy.e_prob is st_t.e_prob and lazy.p_ibd is st_t.p_ibd
