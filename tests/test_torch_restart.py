"""The multi-restart protocol of the port (ngsf_hmm_tpu_torch.models
.restart, flattened replicates on the emission-slab chain kernels, CPU)
against the JAX package (ngsf_hmm_tpu.models.restart), on the simulated
300 x 4 data of tests/test_restart.py.

Gates and why:
- stack_restart_states: the host draws (freq, indF, alpha) equal the JAX
  ones exactly after the cast to float32; e_prob (a log-sum-exp of the
  same inputs in two libraries) within 1e-6.
- run_em_restarts against JAX run_em_restarts(numerics="linear",
  block_size="auto"): the JAX package's own gates between its flattened
  and its vmapped routes (tests/test_restart.py:116-128): rep_lkl rtol
  2e-5, rep_iters equal, best indF / freq atol 2e-4.
- one flattened em_iteration (n_rep=2, S=260, N=40: the slab est_maf
  route) with (F, alpha) fixed, against JAX em_iteration(
  numerics="linear", block_size=32, n_rep=2): freq [R, S] atol 2e-5.
- each port replicate r against the port's single run_em seeded seed + r
  (emission-slab route against the fused route): tot_lkl rtol 2e-5,
  equal iterations.
"""

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ngsf_hmm_tpu.io import readers as j_readers
from ngsf_hmm_tpu.models import em as j_em
from ngsf_hmm_tpu.models import restart as j_restart
from ngsf_hmm_tpu.ops.hwe import post_prob as j_post_prob
from ngsf_hmm_tpu.tools.simulate import simulate
from ngsf_hmm_tpu_torch import convert
from ngsf_hmm_tpu_torch.io.gsl_rng import GslTaus
from ngsf_hmm_tpu_torch.io.init import init_freq, init_indF_alpha
from ngsf_hmm_tpu_torch.models import em as t_em
from ngsf_hmm_tpu_torch.models import restart as t_restart
from ngsf_hmm_tpu_torch.models.lbfgsb import MVAL
from test_torch_maf import observed, realistic_gls
from test_torch_package import REPO, _run

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

R, SEED = 3, 17
LOOP = dict(min_iters=2, max_iters=6, min_epsilon=1e-4)
SIM = dict(n_ind=4, n_sites=300, freq="0.2", site_pos="r", indF="0.5",
           alpha="0.01", depth="2", error=0.01, seed=99)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """tests/test_restart.py's data: (gl [300, 4, 3] float32 log, dist)."""
    d = tmp_path_factory.mktemp("restart")
    simulate(out=str(d / "sim"), **SIM)
    gl = j_readers.read_geno(str(d / "sim.glf.gz"), 4, 300, probs=True,
                             log_scale=True)
    dist = j_readers.read_pos_dist(str(d / "sim.pos.gz"), 300) / 1e6
    gl = np.asarray(j_post_prob(jnp.asarray(gl), None), np.float32)
    return gl, dist.astype(np.float32)


@pytest.fixture(scope="module")
def runs(sim):
    gl, dist = sim
    states_j = j_restart.stack_restart_states(jnp.asarray(gl), R, SEED)
    r_j = j_restart.run_em_restarts(
        jnp.asarray(gl), jnp.asarray(dist), states_j,
        j_em.EMOptions(numerics="linear", block_size="auto", **LOOP))
    arrays = {k: np.array(getattr(states_j, k))
              for k in convert.STATE_FIELDS}
    states_t = convert.state_from_jax(arrays, device="cpu")
    opts = t_em.EMOptions(numerics="pallas", verbose=0, **LOOP)
    r_t = t_restart.run_em_restarts(gl, dist, states_t, opts, device="cpu")
    return dict(gl=gl, dist=dist, arrays=arrays, jax=r_j, port=r_t,
                opts=opts)


def test_stack_restart_states_equal_jax(sim, runs):
    gl, _ = sim
    st = t_restart.stack_restart_states(gl, R, SEED, device="cpu")
    a = runs["arrays"]
    assert st.indF.shape == (R, 4) and st.e_prob.shape == (R, 300, 4, 2)
    for k in ("freq", "indF", "alpha", "p_ibd", "ind_lkl"):
        assert torch.equal(getattr(st, k),
                           torch.as_tensor(a[k]).float()), k
    np.testing.assert_allclose(st.e_prob.numpy(), a["e_prob"], atol=1e-6)
    # the draws are GslTaus(seed + r)'s
    rng = GslTaus(SEED + 2)
    indF0, alpha0 = init_indF_alpha("r", 4, rng)
    assert np.array_equal(st.indF[2].numpy(), indF0.astype(np.float32))
    assert np.array_equal(st.freq[2].numpy(),
                          init_freq("r", 300, rng).astype(np.float32))


def test_run_em_restarts_matches_jax(runs):
    rj, rt = runs["jax"], runs["port"]
    observed("restart rep_lkl", rt.rep_lkl, rj.rep_lkl)
    np.testing.assert_allclose(rt.rep_lkl, rj.rep_lkl, rtol=2e-5)
    np.testing.assert_array_equal(rt.rep_iters, rj.rep_iters)
    assert rt.best.tot_lkl == pytest.approx(rj.best.tot_lkl, rel=2e-5)
    np.testing.assert_allclose(rt.best.state.indF.numpy(),
                               np.asarray(rj.best.state.indF), atol=2e-4)
    np.testing.assert_allclose(rt.best.state.freq.numpy(),
                               np.asarray(rj.best.state.freq), atol=2e-4)
    # the winner is the argmax and carries its own state and path
    assert rt.best_rep == int(np.argmax(rt.rep_lkl))
    assert rt.best.path.shape == (300, 4)
    assert rt.best.state.e_prob.shape == (300, 4, 2)
    assert rt.rep_freq.shape == (R, 300)
    assert np.array_equal(rt.rep_freq[rt.best_rep], rt.best.state.freq.numpy())
    # the winner's total at every lockstep iteration, its last the final
    assert len(rt.best.lkl_history) == max(rt.rep_iters)
    assert rt.best.lkl_history[-1] == rt.best.tot_lkl


def test_replicates_match_single_runs(runs):
    """Replicate r of the lockstep run (emission-slab route) against the
    port's single run_em seeded seed + r (fused route)."""
    gl, dist = runs["gl"], runs["dist"]
    for r in range(R):
        rng = GslTaus(SEED + r)
        indF0, alpha0 = init_indF_alpha("r", 4, rng)
        freq0 = init_freq("r", 300, rng)
        st = t_em.init_state(gl, freq0, indF0, alpha0, device="cpu")
        res = t_em.run_em(gl, dist, st, runs["opts"], device="cpu")
        assert runs["port"].rep_lkl[r] == pytest.approx(res.tot_lkl,
                                                         rel=2e-5), r
        assert runs["port"].rep_iters[r] == res.n_iters, r


def test_flat_state_conversions(runs):
    """flatten_states / take_replicate are inverses on the columns; the
    stacked state and the [m, R*N, 2] L-BFGS memory move both ways
    through convert; the winner keeps its own N columns of the memory; a
    converged replicate is frozen."""
    st = convert.state_from_jax(runs["arrays"], device="cpu")
    flat = t_restart.flatten_states(st)
    assert flat.e_prob.shape == (300, R * 4, 2) and flat.freq.shape == (R, 300)
    for r in range(R):
        one = t_restart.take_replicate(flat, r)
        for k in convert.STATE_FIELDS:
            assert torch.equal(getattr(one, k), getattr(st, k)[r]), (k, r)
    back = convert.state_to_jax(st)
    for k in convert.STATE_FIELDS:
        assert np.array_equal(back[k], runs["arrays"][k].astype(np.float32))
    best_mem = runs["port"].best.opt_memory
    assert best_mem[0].shape == (MVAL, 4, 2) and best_mem[3].shape == (4,)
    assert convert.opt_memory_from_jax(
        convert.opt_memory_to_jax(best_mem), 4, device="cpu") is not None
    _, _, mem = t_em.em_iteration(
        torch.as_tensor(runs["gl"]), torch.as_tensor(runs["dist"]), flat,
        n_rep=R, numerics="pallas", return_opt=True)
    assert mem[0].shape == (MVAL, R * 4, 2) and mem[3].shape == (R * 4,)
    host = convert.opt_memory_to_jax(mem)
    again = convert.opt_memory_from_jax(host, R * 4, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(mem, again))
    assert convert.opt_memory_from_jax(host, 4, device="cpu") is None
    moved = flat._replace(indF=flat.indF + 1.0, freq=flat.freq + 1.0)
    kept = t_restart._freeze(moved, flat, np.array([True, False, True]))
    assert torch.equal(kept.indF[4:8], flat.indF[4:8])
    assert torch.equal(kept.indF[:4], moved.indF[:4])
    assert torch.equal(kept.freq[1], flat.freq[1])


def test_flat_em_iteration_matches_jax():
    """One flattened em_iteration, n_rep = 2 at S = 260, N = 40 (the slab
    est_maf route, snapped posterior), (F, alpha) fixed on both sides."""
    rng = np.random.default_rng(260)
    S, N, n_rep = 260, 40, 2
    gl = np.log(realistic_gls(rng, S, N)).astype(np.float32)
    dist = rng.uniform(1e-6, 1e-4, S).astype(np.float32)
    dist[130] = np.inf
    st_j = j_restart.stack_restart_states(jnp.asarray(gl), n_rep, 5)
    a = {k: np.array(getattr(st_j, k)) for k in convert.STATE_FIELDS}
    flat_t = t_restart.flatten_states(convert.state_from_jax(a, device="cpu"))
    flat_j = j_em.EMState(*(jnp.asarray(getattr(flat_t, k).numpy())
                            for k in convert.STATE_FIELDS))
    fixed = dict(freq_est=1, indF_fixed=True, alpha_fixed=True, n_rep=n_rep)
    sj, stats_j = j_em.em_iteration(jnp.asarray(gl), jnp.asarray(dist),
                                    flat_j, numerics="linear", block_size=32,
                                    **fixed)
    st, stats = t_em.em_iteration(torch.as_tensor(gl), torch.as_tensor(dist),
                                  flat_t, numerics="pallas", **fixed)
    assert st.freq.shape == (n_rep, S) and stats.fwbw_maxdiff.shape == (2,)
    assert float(stats.fwbw_maxdiff.max()) < 1e-3 and stats.opt_iters == 0
    observed("flattened em_iteration freq", st.freq, sj.freq)
    np.testing.assert_allclose(st.freq.numpy(), np.asarray(sj.freq),
                               atol=2e-5)
    np.testing.assert_allclose(st.ind_lkl.numpy(), np.asarray(sj.ind_lkl),
                               rtol=2e-6)
    np.testing.assert_allclose(st.p_ibd.numpy(), np.asarray(sj.p_ibd),
                               atol=1e-3)
    # each replicate's columns carry its own freq's emissions
    for r in range(n_rep):
        want = t_em.rebuild_eprob(torch.as_tensor(gl), st.freq[r])
        assert torch.equal(st.e_prob[:, r * N:(r + 1) * N], want)


def test_restart_cli_on_cpu(tmp_path):
    """--n_rep 3 --device cpu through the port's CLI on its fused tier
    (--dtype float32 --kernel pallas; as
    tests/test_restart.py::test_restart_cli_flag): the best replicate's
    three files, the .indF header its log-likelihood; stdout line for line
    the JAX CLI's (its default tier) on the same inputs and flags, numbers
    and the package tag masked: in particular no "Calculating initial
    emission probabilities" line, which the JAX CLI prints only for a
    single-run init (ngsf_hmm_tpu/cli.py:695); without --device cpu and
    without a card the CLI errors out."""
    simulate(out=str(tmp_path / "sim"), **SIM)
    args = ("--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 4 "
            "--n_sites 300 --freq r --indF r --seed 5 --n_rep 3 "
            "--min_iters 3 --max_iters 10 --min_epsilon 1e-4 "
            "--out multi --device cpu").split()
    from ngsf_hmm_tpu_torch.cli import main

    cwd, buf = os.getcwd(), io.StringIO()
    try:
        os.chdir(tmp_path)
        with contextlib.redirect_stdout(buf):
            # the port on its fused tier (the JAX CLI below on its default)
            rc = main(args + ["--dtype", "float32", "--kernel", "pallas"])
    finally:
        os.chdir(cwd)
    assert rc == 0
    out = buf.getvalue()
    assert "Replicate 1:" in out and "<== best" in out
    assert "LogLkl (best replicate" in out
    first = float((tmp_path / "multi.indF").read_text().splitlines()[0])
    best = max(float(line.split()[3]) for line in out.splitlines()
               if line.startswith("Replicate"))
    assert first == pytest.approx(best, abs=1e-4)
    assert (tmp_path / "multi.geno").stat().st_size == 300 * 4 * 3 * 8
    assert len((tmp_path / "multi.ibd").read_text().splitlines()) > 0
    assert "Calculating initial emission probabilities" not in out

    jdir = tmp_path / "jax"
    jdir.mkdir()
    for f in ("sim.glf.gz", "sim.pos.gz"):
        shutil.copy(tmp_path / f, jdir / f)
    j = subprocess.run(
        [sys.executable, "-m", "ngsf_hmm_tpu", *args[:-2]],
        env=dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu"),
        cwd=jdir, capture_output=True, text=True, timeout=300)
    assert j.returncode == 0, j.stderr

    def masked(text):
        text = re.sub(r"\((tpu|torch)\)", "(package)", text)
        return re.sub(r"nan|[-+]?\d+(\.\d+)?(e[-+]?\d+)?", "#",
                      text).splitlines()

    assert masked(out) == masked(j.stdout)
    if not torch.cuda.is_available():
        r = _run([a if a != "cpu" else "cuda" for a in args], module=True)
        assert r.returncode != 0 and "no CUDA device" in r.stderr


@pytest.mark.parametrize("kw", [dict(freq_est=2), dict(e_prob_calc=2)],
                         ids=["freq_est2", "e_prob2"])
def test_refuse_ld_modes_with_replicates(kw):
    """On the fused tier the JAX package runs these replicates on its
    linear tier, which the port does not have: refused, naming the
    ROADMAP item. The scan tier runs them (tests/test_torch_log_ld_restart
    .py)."""
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1: 'models/hmm_blocked.py'"):
        t_em._refuse(n_rep=3, numerics="pallas", **kw)
    t_em._refuse(n_rep=3, numerics="log", **kw)
    t_em._refuse(n_rep=3, numerics="pallas")  # freq_est 1, e_prob_calc 1
    t_em._refuse(n_rep=3, numerics="pallas", freq_est=0)
