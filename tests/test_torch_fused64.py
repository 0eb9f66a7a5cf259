"""A float64 state on the fused tier (--dtype float64 --kernel pallas;
CPU, the kernels' plain versions). As in the JAX package, the kernels
read float32 (gl slabs, or bfloat16 under gl_bf16; freq, F and alpha at
their boundary), their outputs (p_raw, ll_f, ll_b, est_maf's freq) are
cast to the state's float64, gl_lin and the emissions are formed in
float64 and L-BFGS runs on float64 (F, alpha).

- one fused em_iteration at S = 307, N = 8 (the exact est_maf route)
  against the JAX package's em_iteration(numerics="pallas") on the same
  float64 state, its Pallas kernels in interpret mode as the JAX tests
  run them (the file's one JAX compilation), at the gates of
  tests/test_torch_em_freq.py: freq atol 1e-3, indF atol 2e-3, p_ibd and
  e_prob atol 1e-3, ind_lkl rtol 1e-5; alpha atol 2e-3 + rtol 1e-3 of
  the float64 optimum (the scan tier's iteration from the same state,
  which tests/test_torch_log_em.py holds to JAX float64 at rtol 1e-8),
  and of JAX's within JAX's own distance to that optimum: JAX's fused
  combine returns float32 log-likelihoods, so its float64 L-BFGS stops
  0.0057 from the optimum on a flat alpha, the port's (float64
  log-likelihoods) 0.0017;
- the float64 restarts on the emission-slab route (R = 2 flattened) and
  the float64 state under gl_bf16, each against the same computation on
  the float32 state (whose own gates against JAX are
  tests/test_torch_restart.py's and tests/test_torch_bf16.py's): the
  kernels see the same float32 inputs up to the rounding of exp in the
  two types, so p_ibd atol 2e-5 (the float32 gate; bit-equal under
  gl_bf16, where both read the same slabs), freq atol 1e-4, ind_lkl
  rtol 1e-6; F and alpha at the optimizer gate of the float64 optimum
  (the scan tier's iteration, under gl_bf16 on the gl the kernels read:
  g0 and g2 rounded to bfloat16, g1 = 1 - g0 - g2);
- run_em in float64: its exit rebuilds (rebuild_eprob, the deferred
  posterior) in float64 and equal to the live loop's bit for bit; the
  CLI's --kernel pallas (float64 by default) with and without --gl_bf16 1.
"""

import contextlib
import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from ngsf_hmm_tpu.models import em as j_em
from test_torch_maf import observed
from ngsf_hmm_tpu_torch import convert
from ngsf_hmm_tpu_torch.models import em as t_em
from ngsf_hmm_tpu_torch.models import restart as t_restart
from ngsf_hmm_tpu_torch.ops.emissions import calc_emission

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

f32, f64 = torch.float32, torch.float64
S, N = 307, 8
OPT = dict(atol=2e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    gl, freq, dist, F, alpha, _ = oracle.random_case(
        rng, S=S, N=N, chrom_break_every=120)
    gl = np.ascontiguousarray(np.transpose(gl, (1, 0, 2)))  # [S, N, 3]
    st_j = j_em.init_state(jnp.asarray(gl), jnp.asarray(freq),
                           jnp.asarray(F), jnp.asarray(alpha))
    arrays = {k: np.array(getattr(st_j, k)) for k in convert.STATE_FIELDS}
    assert arrays["e_prob"].dtype == np.float64
    return dict(gl=gl, dist=dist, st_j=st_j, arrays=arrays,
                gl_t=torch.as_tensor(gl), dist_t=torch.as_tensor(dist))


def _state(arrays, dtype):
    return convert.state_from_jax(arrays, device="cpu", dtype=dtype)


def test_fused_em_iteration_f64_matches_jax(case):
    """freq_est 1, e_prob_calc 1 on the fused route with a float64 state,
    against JAX's float64 state on its Pallas kernels (interpret mode)."""
    with pytest.MonkeyPatch.context() as mp:
        # the package's own sites-per-grid-step knob keeps the
        # interpret-mode trace of the jitted iteration short
        mp.setenv("NGSF_PALLAS_R", "8")
        sj, stat_j = j_em.em_iteration(
            jnp.asarray(case["gl"]), jnp.asarray(case["dist"]),
            case["st_j"], numerics="pallas")
    st, stat = t_em.em_iteration(case["gl_t"], case["dist_t"],
                                 _state(case["arrays"], f64),
                                 numerics="pallas")
    opt, _ = t_em.em_iteration(case["gl_t"], case["dist_t"],
                               _state(case["arrays"], f64))
    for k in convert.STATE_FIELDS:
        assert getattr(st, k).dtype == f64, k
        observed(f"fused float64 {k}", np.nan_to_num(getattr(st, k).numpy()),
                 np.nan_to_num(np.asarray(getattr(sj, k))))
    np.testing.assert_allclose(st.freq.numpy(), np.asarray(sj.freq),
                               atol=1e-3)
    np.testing.assert_allclose(st.indF.numpy(), np.asarray(sj.indF),
                               atol=2e-3)
    a, a_j, a_64 = (x.numpy() if torch.is_tensor(x) else np.asarray(x)
                    for x in (st.alpha, sj.alpha, opt.alpha))
    print(f"observed fused float64 alpha: port - optimum "
          f"{np.abs(a - a_64).max():.3g}, JAX - optimum "
          f"{np.abs(a_j - a_64).max():.3g}")
    np.testing.assert_allclose(a, a_64, **OPT)
    gate = OPT["atol"] + OPT["rtol"] * np.abs(a_64)
    assert (np.abs(a - a_j) <= np.abs(a_j - a_64) + gate).all()
    np.testing.assert_allclose(st.p_ibd.numpy(), np.asarray(sj.p_ibd),
                               atol=1e-3)
    np.testing.assert_allclose(st.ind_lkl.numpy(), np.asarray(sj.ind_lkl),
                               rtol=1e-5)
    ej = np.asarray(sj.e_prob)
    fin = np.isfinite(ej)
    np.testing.assert_allclose(st.e_prob.numpy()[fin], ej[fin], atol=1e-3)
    assert stat.opt_iters == int(stat_j.opt_iters)


def _close(got, want, opt, what):
    """A float64-state result against the float32 state's, its (F, alpha)
    against the float64 optimum opt."""
    for k in ("freq", "indF", "alpha", "p_ibd", "ind_lkl"):
        g = getattr(got, k)
        assert g.dtype == f64, (what, k)
        observed(f"{what} {k} float64 - float32", g.numpy(),
                 getattr(want, k).double().numpy())
    np.testing.assert_allclose(got.p_ibd.numpy(), want.p_ibd.double().numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(got.freq.numpy(), want.freq.double().numpy(),
                               atol=1e-4)
    for k in ("indF", "alpha"):
        print(f"observed {what} {k} float64 - optimum "
              f"{float((getattr(got, k) - getattr(opt, k)).abs().max()):.3g}")
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   getattr(opt, k).numpy(), **OPT)
    np.testing.assert_allclose(got.ind_lkl.numpy(),
                               want.ind_lkl.double().numpy(), rtol=1e-6)


def test_flattened_restarts_f64(case):
    """R = 2 replicates of float64 states flattened on the emission-slab
    route (one em_iteration, n_rep=2) against the same on float32 states;
    per-replicate fwbw, the freq [R, S] in float64."""
    a, b = case["arrays"], {k: v.copy() for k, v in case["arrays"].items()}
    rng = np.random.default_rng(4)
    b["indF"] = rng.uniform(0.05, 0.6, N)
    b["alpha"] = rng.uniform(0.01, 0.3, N)
    stacked = {k: np.stack([a[k], b[k]]) for k in convert.STATE_FIELDS}
    out = {}
    for dt in (f64, f32):
        flat = t_restart.flatten_states(_state(stacked, dt))
        out[dt] = t_em.em_iteration(case["gl_t"].to(dt),
                                    case["dist_t"].to(dt), flat,
                                    numerics="pallas", n_rep=2)
    st, stat = out[f64]
    assert st.freq.shape == (2, S) and stat.fwbw_maxdiff.shape == (2,)
    opt, _ = t_em.em_iteration(
        case["gl_t"], case["dist_t"],
        t_restart.flatten_states(_state(stacked, f64)), n_rep=2)
    _close(st, out[f32][0], opt, "restarts")
    e32 = out[f32][0].e_prob.double()
    fin = torch.isfinite(e32)
    assert st.e_prob.dtype == f64
    assert float((st.e_prob[fin] - e32[fin]).abs().max()) < 1e-4


def test_gl_bf16_f64(case):
    """gl_bf16 with a float64 state: the kernels read bfloat16 slabs of
    the float64 gl (rounded through float32, as the float32 state's are),
    against the float32 state's bfloat16 iteration."""
    out = {}
    for dt in (f64, f32):
        out[dt] = t_em.em_iteration(case["gl_t"].to(dt),
                                    case["dist_t"].to(dt),
                                    _state(case["arrays"], dt),
                                    numerics="pallas", gl_bf16=True,
                                    return_prep=True)
    st, _, slabs = out[f64]
    assert slabs[0].dtype == torch.bfloat16
    assert torch.equal(slabs[0], out[f32][2][0])
    assert torch.equal(st.p_ibd, out[f32][0].p_ibd.double())
    # the float64 optimum on the gl the kernels read: g0 and g2 rounded to
    # bfloat16 (through float32), g1 = 1 - g0 - g2
    q = torch.exp(case["gl_t"]).float().to(torch.bfloat16).double()
    gq = torch.log(torch.stack([q[..., 0], 1.0 - q[..., 0] - q[..., 2],
                                q[..., 2]], -1))
    st0 = _state(case["arrays"], f64)
    st0 = st0._replace(e_prob=calc_emission(gq, st0.freq[:, None]))
    opt, _ = t_em.em_iteration(gq, case["dist_t"], st0)
    _close(st, out[f32][0], opt, "gl_bf16")


def test_run_em_f64_fused_rebuilds_in_float64(case):
    """run_em on the fused tier with a float64 state: the deferred
    e_prob and p_ibd are rebuilt at loop exit in float64, equal bit for
    bit to the live loop's (verbose 7); the path is a Viterbi path of
    the float64 emissions."""
    loop = dict(min_iters=2, max_iters=3, min_epsilon=100.0,
                numerics="pallas")
    st0 = _state(case["arrays"], f64)
    lazy = t_em.run_em(case["gl"], case["dist"], st0,
                       t_em.EMOptions(verbose=0, **loop), device="cpu")
    live = t_em.run_em(case["gl"], case["dist"], st0,
                       t_em.EMOptions(verbose=7, **loop), device="cpu")
    assert lazy.n_iters == live.n_iters == 2
    for k in convert.STATE_FIELDS:
        assert getattr(lazy.state, k).dtype == f64, k
        assert torch.equal(getattr(live.state, k), getattr(lazy.state, k)), k
    assert torch.equal(lazy.state.e_prob, t_em.rebuild_eprob(
        case["gl_t"], lazy.state.freq))
    assert np.array_equal(live.path, lazy.path)


@pytest.mark.parametrize("bf16", ["0", "1"], ids=["float32-gl", "bf16-gl"])
def test_cli_pallas_float64(tmp_path, bf16):
    """--kernel pallas, float64 by default (the JAX CLI's --dtype), with
    and without --gl_bf16 1, runs on the CPU."""
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
                   "--kernel", "pallas", "--gl_bf16", bf16])
    out = buf.getvalue()
    assert rc == 0 and "Final logLkl" in out
    assert "\tdtype: float64" in out or "dtype" not in out
