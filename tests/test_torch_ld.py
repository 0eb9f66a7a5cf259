"""The LD path of the port (--e_prob 2, --freq_est 2) against the JAX
package, on the CPU (plain versions of the kernels).

- One em_iteration with e_prob_calc 2, freq_est 1 on the emission-slab
  route (v1 chain kernels, est_maf_rows) against JAX em_iteration(
  numerics="pallas", gl_tiles=...), which reaches the v1 Pallas kernels
  _k_block_transfer / _k_bw_sites / _k_block_transfer_grad / _k_fw_post
  and _run_macro in interpret mode, float32, one state carried across
  with convert.state_from_jax. Allowed: freq and p_ibd atol 2e-5 (the
  pallas-vs-XLA gate), log-likelihoods rtol 2e-6, (F, alpha) atol 2e-3
  (the two optimizers' endpoints agree to the shared PGTOL).
- run_em with freq_est 2, e_prob 2 (the haplotype EM every iteration, LD
  emissions) against JAX run_em(numerics="linear", block_size=...), 3
  iterations, on data made as tests/test_ld_path.py makes its 300 x 6
  case. Allowed: tot_lkl rtol 1e-5, indF / alpha atol 2e-3, freq atol
  1e-3.
- The CLI with --freq_est 2 --e_prob 2 on the CPU.
"""

import contextlib
import io
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ngsf_hmm_tpu.models import em as j_em
from ngsf_hmm_tpu.ops import maf_pallas as j_mp
from ngsf_hmm_tpu.tools.simulate import simulate
from ngsf_hmm_tpu_torch import convert
from ngsf_hmm_tpu_torch.models import em as t_em
from ngsf_hmm_tpu_torch.utils.cuda_lib import PLAIN_CALLS
from test_torch_maf import observed

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

# the JAX CLI's warning (ngsf_hmm_tpu/cli.py:679-687), up to its last
# sentence, which names the module of each package
WARNING = ("the LD path (--freq_est 2 / --e_prob 2) is non-functional in "
           "the reference (NaN haplotype frequencies; gen_func.cpp:1160); "
           "running the CORRECTED two-site haplotype EM instead -- at init "
           "too (parse_args.cpp:316-321,373-386) -- results will not "
           "match the (broken) reference.")


def test_em_iteration_ld_matches_jax(monkeypatch):
    """e_prob_calc 2, freq_est 1, S = 260, N = 40 (schedule (16, (8, 16,
    32, 29))), seed 260: every kernel of the route runs (its plain
    version here), and the result agrees with the Pallas route."""
    S, N = 260, 40
    rng = np.random.default_rng(260)
    raw = rng.random((S, N, 3)) + 1e-3
    gl = np.log(raw / raw.sum(-1, keepdims=True)).astype(np.float32)
    dist = (rng.random(S) * 0.01 + 1e-4).astype(np.float32)
    dist[130] = np.inf  # a chromosome break
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    st_j = j_em.init_state(jnp.asarray(gl), f32(np.full(S, 0.2)),
                           f32(rng.uniform(0.1, 0.4, N)),
                           f32(rng.uniform(0.02, 0.2, N)), e_prob_calc=2)
    arrays = {k: np.array(getattr(st_j, k)) for k in convert.STATE_FIELDS}
    # the package's own sites-per-grid-step knob keeps the interpret-mode
    # trace of the jitted iteration short
    monkeypatch.setenv("NGSF_PALLAS_R", "8")
    sj, stats_j = j_em.em_iteration(
        jnp.asarray(gl), jnp.asarray(dist), st_j, freq_est=1, e_prob_calc=2,
        numerics="pallas",
        gl_tiles=j_mp.prepare_gl_tiles(jnp.exp(jnp.asarray(gl))))

    PLAIN_CALLS.clear()
    st_t = convert.state_from_jax(arrays, device="cpu")
    s, stats = t_em.em_iteration(torch.as_tensor(gl), torch.as_tensor(dist),
                                 st_t, freq_est=1, e_prob_calc=2,
                                 numerics="pallas")
    assert {"block_transfer_v1", "bw_sites_v1", "fw_post_v1",
            "block_transfer_grad_v1", "combine_blocks",
            "maf_macro"} <= set(PLAIN_CALLS)
    assert not {"block_transfer", "block_transfer_grad", "maf_state_grad",
                "maf_exact"} & set(PLAIN_CALLS)
    observed("LD em_iteration freq", s.freq, np.asarray(sj.freq))
    observed("LD em_iteration p_ibd", s.p_ibd, np.asarray(sj.p_ibd))
    observed("LD em_iteration ind_lkl", s.ind_lkl, np.asarray(sj.ind_lkl))
    observed("LD em_iteration indF", s.indF, np.asarray(sj.indF))
    observed("LD em_iteration alpha", s.alpha, np.asarray(sj.alpha))
    np.testing.assert_allclose(s.freq.numpy(), np.asarray(sj.freq),
                               atol=2e-5)
    np.testing.assert_allclose(s.p_ibd.numpy(), np.asarray(sj.p_ibd),
                               atol=2e-5)
    np.testing.assert_allclose(s.ind_lkl.numpy(), np.asarray(sj.ind_lkl),
                               rtol=2e-6)
    assert float(stats.fwbw_maxdiff) < 1e-3
    np.testing.assert_allclose(s.indF.numpy(), np.asarray(sj.indF),
                               atol=2e-3)
    np.testing.assert_allclose(s.alpha.numpy(), np.asarray(sj.alpha),
                               atol=2e-3)
    # e_prob_calc 2: only site 0's emission is recomputed (EM.cpp:252),
    # the LD emissions of the others stay as init made them
    assert torch.equal(s.e_prob[1:], st_t.e_prob[1:])
    np.testing.assert_allclose(s.e_prob[0].numpy(),
                               np.asarray(sj.e_prob)[0], atol=2e-5)


def test_run_em_freq_est2_e_prob2_matches_jax():
    """freq_est 2 + e_prob 2 for 3 iterations (min_iters 3, max_iters 4,
    min_epsilon 100), S = 300, N = 6, seed 13, flat init freq 0.2, indF
    0.3, alpha 0.05 (tests/test_ld_path.py's case), against the JAX linear
    tier."""
    S, N = 300, 6
    rng = np.random.default_rng(13)
    raw = rng.random((S, N, 3)) + 1e-3
    gl = np.log(raw / raw.sum(-1, keepdims=True)).astype(np.float32)
    dist = (np.abs(rng.random(S)) * 0.01 + 1e-4).astype(np.float32)
    f32 = lambda v, n: jnp.full((n,), v, jnp.float32)
    loop = dict(freq_est=2, e_prob_calc=2, min_iters=3, max_iters=4,
                min_epsilon=100.0, verbose=0)
    st_j = j_em.init_state(jnp.asarray(gl), f32(0.2, S), f32(0.3, N),
                           f32(0.05, N), e_prob_calc=2)
    rj = j_em.run_em(jnp.asarray(gl), jnp.asarray(dist), st_j,
                     j_em.EMOptions(numerics="linear", block_size=64,
                                    **loop))
    st_t = t_em.init_state(gl, np.full(S, 0.2), np.full(N, 0.3),
                           np.full(N, 0.05), e_prob_calc=2, device="cpu")
    rt = t_em.run_em(gl, dist, st_t,
                     t_em.EMOptions(numerics="pallas", **loop), device="cpu")
    assert rt.n_iters == rj.n_iters == 3
    observed("LD run_em freq", rt.state.freq, np.asarray(rj.state.freq))
    observed("LD run_em tot_lkl", rt.tot_lkl, rj.tot_lkl)
    observed("LD run_em indF", rt.state.indF, np.asarray(rj.state.indF))
    observed("LD run_em alpha", rt.state.alpha, np.asarray(rj.state.alpha))
    np.testing.assert_allclose(rt.tot_lkl, rj.tot_lkl, rtol=1e-5)
    np.testing.assert_allclose(rt.lkl_history, rj.lkl_history, rtol=1e-5)
    np.testing.assert_allclose(rt.state.indF.numpy(),
                               np.asarray(rj.state.indF), atol=2e-3)
    np.testing.assert_allclose(rt.state.alpha.numpy(),
                               np.asarray(rj.state.alpha), atol=2e-3)
    np.testing.assert_allclose(rt.state.freq.numpy(),
                               np.asarray(rj.state.freq), atol=1e-3)
    assert np.isfinite(rt.state.e_prob.numpy()).all()
    assert rt.path.shape == (S, N) and np.isin(rt.path, (0, 1)).all()


def test_cli_ld_path_on_cpu(tmp_path):
    """python -m ngsf_hmm_tpu_torch --freq_est 2 --e_prob 2 --freq e on
    the 200 x 4 data of tests/test_ld_path.py::test_cli_ld_path: exit 0,
    the JAX package's warning on stderr, finite .indF values; with
    --n_rep 2 the same flags are refused."""
    from ngsf_hmm_tpu_torch.cli import main

    simulate(n_ind=4, n_sites=200, freq="0.2", site_pos="r", indF="0.5",
             alpha="0.01", depth="2", error=0.01, seed=31,
             out=str(tmp_path / "sim"))
    args = ("--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 4 "
            "--n_sites 200 --freq e --indF 0.3,0.05 --freq_est 2 "
            "--e_prob 2 --min_iters 2 --max_iters 6 --min_epsilon 1e-3 "
            "--device cpu --dtype float32 --kernel pallas "
            "--out ld").split()
    cwd = os.getcwd()
    out, err = io.StringIO(), io.StringIO()
    try:
        os.chdir(tmp_path)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(args)
    finally:
        os.chdir(cwd)
    assert rc == 0
    assert WARNING in " ".join(err.getvalue().split())
    assert "Final logLkl" in out.getvalue()
    lines = (tmp_path / "ld.indF").read_text().splitlines()
    assert len(lines) == 1 + 4 + 200
    vals = [float(x) for line in lines for x in line.split() if x != "NA"]
    assert np.all(np.isfinite(vals))
    assert (tmp_path / "ld.geno").stat().st_size == 200 * 4 * 3 * 8
    with pytest.raises(SystemExit) as exc:
        main(args + ["--n_rep", "2", "--verbose", "0"])
    assert exc.value.code != 0
