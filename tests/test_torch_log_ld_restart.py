"""The scan tier's replicates in the LD modes (CPU, float64, the kernels'
plain versions): models/restart.run_em_restarts with numerics "log" and
--freq_est 2 / --e_prob 0 or 2, R replicates flattened into the columns,
each replicate's freq M-step on its own freq, emissions and posterior
columns (models/em._freq_step_log).

- freq_est 2 with e_prob_calc 2 against the JAX package's vmapped
  run_em_restarts(numerics="log") (restart.py:182-198; the file's one JAX
  compilation) from the same stacked states, at tests/test_torch_log_em.py's
  scan-tier gates: rep_lkl rtol 1e-9, rep_iters equal, the winner's
  F, alpha and freq rtol 1e-7, its Viterbi path equal;
- freq_est 1 with e_prob_calc 0 and 2: one flattened em_iteration of two
  replicates against the port's own single-run em_iteration of each on
  the same init (no further JAX compilation: the single run is held to
  JAX by tests/test_torch_log_em.py). The chain's block geometry depends
  on the column count, so the sums associate otherwise: freq rtol 1e-9,
  p_ibd atol 1e-9, F and alpha rtol 1e-8, e_prob rtol 1e-8 (the gates
  of tests/test_torch_log_em.py); emissions past site 0 untouched;
- stack_restart_states with e_prob_calc 2: each replicate's LD pair
  emissions are init_state's from its own freq0, bit for bit;
- the CLI's --n_rep 3 with --freq_est 2 --e_prob 2 and with --e_prob 0.
"""

import contextlib
import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from ngsf_hmm_tpu.models import em as j_em
from ngsf_hmm_tpu.models import restart as j_restart
from test_torch_maf import observed
from ngsf_hmm_tpu_torch import convert
from ngsf_hmm_tpu_torch.io.gsl_rng import GslTaus
from ngsf_hmm_tpu_torch.io.init import init_freq, init_indF_alpha
from ngsf_hmm_tpu_torch.models import em as t_em
from ngsf_hmm_tpu_torch.models import restart as t_restart

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

S, N, R, SEED = 160, 5, 3, 11
LOOP = dict(min_iters=2, max_iters=3, min_epsilon=100.0, verbose=0)
LD = dict(freq_est=2, e_prob_calc=2)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(77)
    gl, _, dist, _, _, _ = oracle.random_case(rng, S=S, N=N,
                                              chrom_break_every=70)
    gl = np.ascontiguousarray(np.transpose(gl, (1, 0, 2)))  # [S, N, 3]
    return gl, dist


@pytest.fixture(scope="module")
def runs(data):
    gl, dist = data
    states_j = j_restart.stack_restart_states(jnp.asarray(gl), R, SEED, **LD)
    r_j = j_restart.run_em_restarts(jnp.asarray(gl), jnp.asarray(dist),
                                    states_j, j_em.EMOptions(**LD, **LOOP))
    arrays = {k: np.array(getattr(states_j, k))
              for k in convert.STATE_FIELDS}
    r_t = t_restart.run_em_restarts(
        gl, dist, convert.state_from_jax(arrays, device="cpu"),
        t_em.EMOptions(**LD, **LOOP), device="cpu")
    return dict(arrays=arrays, jax=r_j, port=r_t)


def test_ld_restarts_match_jax_vmapped(runs):
    """freq_est 2 / e_prob_calc 2, three replicates, against the JAX
    package's vmapped em_iteration."""
    rj, rt = runs["jax"], runs["port"]
    assert runs["arrays"]["e_prob"].dtype == np.float64
    observed("LD restart rep_lkl", rt.rep_lkl, rj.rep_lkl)
    np.testing.assert_allclose(rt.rep_lkl, rj.rep_lkl, rtol=1e-9)
    np.testing.assert_array_equal(rt.rep_iters, rj.rep_iters)
    assert rt.best_rep == rj.best_rep
    sj, st = rj.best.state, rt.best.state
    for k in ("freq", "indF", "alpha", "p_ibd"):
        observed(f"LD restart best {k}", getattr(st, k),
                 np.asarray(getattr(sj, k)))
    for k in ("freq", "indF", "alpha"):
        np.testing.assert_allclose(getattr(st, k).numpy(),
                                   np.asarray(getattr(sj, k)), rtol=1e-7,
                                   err_msg=k)
    assert np.array_equal(rt.best.path, np.asarray(rj.best.path))
    assert rt.rep_freq.shape == (R, S)


def test_stacked_ld_emissions_are_each_replicates_own(data):
    """stack_restart_states with e_prob_calc 2 (and freq_est 2's
    initialisation): replicate r's state is init_state's from the draws
    of GslTaus(seed + r), its LD pair emissions from its own freq0."""
    gl, _ = data
    st = t_restart.stack_restart_states(gl, R, SEED, device="cpu", **LD)
    for r in range(R):
        rng = GslTaus(SEED + r)
        indF0, alpha0 = init_indF_alpha("r", N, rng)
        freq0 = init_freq("r", S, rng, gl=torch.as_tensor(gl), freq_est=2,
                          device="cpu")
        one = t_em.init_state(gl, freq0, indF0, alpha0, e_prob_calc=2,
                              device="cpu")
        for k in convert.STATE_FIELDS:
            assert torch.equal(getattr(st, k)[r], getattr(one, k)), (r, k)
    assert not torch.equal(st.e_prob[0, 1:], st.e_prob[1, 1:])


@pytest.mark.parametrize("e_prob_calc", [0, 2])
def test_flat_freq_est1_replicates_match_single_runs(data, e_prob_calc):
    """freq_est 1 with e_prob_calc 0 or 2: replicate r of one flattened
    iteration against the single run's iteration from replicate r's
    init; only site 0's emission is recomputed."""
    gl, dist = data
    gl_t, dist_t = torch.as_tensor(gl), torch.as_tensor(dist)
    stacked = t_restart.stack_restart_states(
        gl, 2, SEED, device="cpu", e_prob_calc=e_prob_calc)
    flat, stat = t_em.em_iteration(gl_t, dist_t,
                                   t_restart.flatten_states(stacked),
                                   n_rep=2, e_prob_calc=e_prob_calc)
    assert stat.fwbw_maxdiff.shape == (2,)
    for r in range(2):
        one = t_restart.take_replicate(t_restart.flatten_states(stacked), r)
        want, _ = t_em.em_iteration(gl_t, dist_t, one,
                                    e_prob_calc=e_prob_calc)
        got = t_restart.take_replicate(flat, r)
        for k in convert.STATE_FIELDS:
            observed(f"e_prob {e_prob_calc} replicate {r} {k}",
                     getattr(got, k), getattr(want, k))
        np.testing.assert_allclose(got.freq.numpy(), want.freq.numpy(),
                                   rtol=1e-9)
        np.testing.assert_allclose(got.p_ibd.numpy(), want.p_ibd.numpy(),
                                   rtol=0, atol=1e-9)
        for k in ("indF", "alpha"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       getattr(want, k).numpy(), rtol=1e-8)
        np.testing.assert_allclose(got.e_prob.numpy(), want.e_prob.numpy(),
                                   rtol=1e-8, atol=1e-9)
        assert torch.equal(got.e_prob[1:], stacked.e_prob[r, 1:])


@pytest.mark.parametrize("flags", [["--freq_est", "2", "--e_prob", "2"],
                                   ["--e_prob", "0"]],
                         ids=["freq_est2-e_prob2", "e_prob0"])
def test_cli_ld_replicates_on_the_scan_tier(tmp_path, flags):
    """--n_rep 3 with the LD modes on the default tier runs on the CPU,
    with the lockstep lines and the replicate summary."""
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
                   "--n_rep", "3", "--freq", "r"] + flags)
    out = buf.getvalue()
    assert rc == 0 and "Final logLkl" in out
    assert "LogLkl (best replicate" in out and "Replicate 3: logLkl" in out
