"""The second slice as a whole: ngsf_hmm_tpu_torch.models.em.run_em with
freq_est 1, the default (CPU, plain versions of the kernels) against
ngsf_hmm_tpu.models.em.run_em with EMOptions(numerics="pallas",
freq_est=1) (Pallas interpret mode), at the shape of tests/test_torch_em.py
(S = 307, N = 8: fewer than 32 individuals, so the exact est_maf route),
both in float32 from one state carried across with convert.state_from_jax.
The slab route (N >= 32) is held in tests/test_torch_maf_kernels.py. Also
here: which emission form the loop carries (equal to the JAX package's for
every tier) and the CLI with the frequencies estimated.

Tolerances: n_iters equal; tot_lkl rtol 1e-5; indF atol 2e-3 and alpha atol
2e-3 + rtol 1e-3 (the two optimizers' endpoints agree to the shared PGTOL,
not bit for bit); freq atol 1e-3, p_ibd atol 1e-3 and e_prob atol 1e-3 on
finite entries (all three follow indF / alpha through the posterior);
Viterbi path mismatch <= 0.5% of cells.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from ngsf_hmm_tpu.models import em as j_em
from test_torch_package import _run
from ngsf_hmm_tpu_torch import convert
from ngsf_hmm_tpu_torch.models import em as t_em

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

S, N = 307, 8
LOOP = dict(min_iters=3, max_iters=4, min_epsilon=100.0, verbose=0)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(21)
    gl, freq, dist, F, alpha, _ = oracle.random_case(
        rng, S=S, N=N, chrom_break_every=120)
    gl = np.transpose(gl, (1, 0, 2)).astype(np.float32)  # [S, N, 3] log
    dist = dist.astype(np.float32)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    st_j = j_em.init_state(jnp.asarray(gl), f32(freq), f32(F), f32(alpha))
    arrays = {k: np.array(getattr(st_j, k)) for k in convert.STATE_FIELDS}
    with pytest.MonkeyPatch.context() as mp:
        # the package's own sites-per-grid-step knob keeps the
        # interpret-mode trace of the jitted iteration short
        mp.setenv("NGSF_PALLAS_R", "8")
        res_j = j_em.run_em(
            jnp.asarray(gl), f32(dist), st_j,
            j_em.EMOptions(numerics="pallas", freq_est=1, **LOOP))
    st_t = convert.state_from_jax(arrays, device="cpu")
    res_t = t_em.run_em(gl, dist, st_t,
                        t_em.EMOptions(numerics="pallas", **LOOP),
                        device="cpu")
    return dict(gl=gl, dist=dist, arrays=arrays, jax1=res_j, port1=res_t,
                st_t=st_t)


def test_run_em_freq_est1_matches_jax(runs):
    """freq_est 1 (the default) on the exact est_maf route, N = 8."""
    assert t_em.EMOptions().freq_est == 1
    rj, rt = runs["jax1"], runs["port1"]
    assert rt.n_iters == rj.n_iters == 3
    assert rt.converged == rj.converged
    np.testing.assert_allclose(rt.tot_lkl, rj.tot_lkl, rtol=1e-5)
    np.testing.assert_allclose(rt.lkl_history, rj.lkl_history, rtol=1e-5)
    sj, st = rj.state, rt.state
    for k in ("freq", "indF", "alpha", "p_ibd"):  # shown by `pytest -rP`
        d = np.abs(getattr(st, k).numpy() - np.asarray(getattr(sj, k))).max()
        print(f"observed run_em freq_est 1 {k}: max abs diff {d:.3g}")
    np.testing.assert_allclose(st.freq.numpy(), np.asarray(sj.freq),
                               atol=1e-3)
    np.testing.assert_allclose(st.indF.numpy(), np.asarray(sj.indF),
                               atol=2e-3)
    # alpha also rtol 1e-3: the likelihood is flat along large alpha (6.4
    # for one individual here), where the two optimizers stop 2.2e-3 apart
    np.testing.assert_allclose(st.alpha.numpy(), np.asarray(sj.alpha),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(st.p_ibd.numpy(), np.asarray(sj.p_ibd),
                               atol=1e-3)
    ej = np.asarray(sj.e_prob)
    fin = np.isfinite(ej)
    np.testing.assert_allclose(st.e_prob.numpy()[fin], ej[fin], atol=1e-3)
    assert np.mean(rt.path != np.asarray(rj.path)) <= 0.005
    # freq moved, stays a frequency, and the emissions are the rebuilt ones
    assert st.freq.shape == (S,) and not np.array_equal(
        st.freq.numpy(), runs["arrays"]["freq"])
    assert float(st.freq.min()) >= 0.0 and float(st.freq.max()) <= 1.0
    assert torch.equal(st.e_prob, t_em.rebuild_eprob(
        torch.as_tensor(runs["gl"]), st.freq))


def test_deferred_state_equals_live_state(runs):
    """run_em defers the e_prob recompute and the posterior unpack to loop
    exit (verbose < 7); verbose 7 keeps both live every iteration. The
    final states are equal bit for bit on the exact route: the rebuilt
    p_ibd is the one the undeferred loop carries."""
    live = t_em.run_em(runs["gl"], runs["dist"],
                       runs["st_t"],
                       t_em.EMOptions(**{**LOOP, "verbose": 7,
                                         "numerics": "pallas"}),
                       device="cpu")
    lazy = runs["port1"]
    assert live.n_iters == lazy.n_iters
    for k in convert.STATE_FIELDS:
        assert torch.equal(getattr(live.state, k), getattr(lazy.state, k)), k
    assert np.array_equal(live.path, lazy.path)


@pytest.mark.parametrize("freq_est", [0, 1, 2])
@pytest.mark.parametrize("numerics", ["log", "linear", "pallas"])
def test_in_loop_emission_form_equals_jax(freq_est, numerics):
    for sharded in (False, True):
        assert t_em.in_loop_emission_form(freq_est, numerics, sharded) == \
            j_em.in_loop_emission_form(freq_est, numerics, sharded)


@pytest.mark.parametrize("flags", [["--freq_est", "1", "--freq", "0.2"],
                                   ["--freq", "e"]],
                         ids=["freq_est1", "default-freq_e"])
def test_cli_estimates_freq_on_cpu(tmp_path, flags):
    """The CLI on the CPU with the frequencies estimated: --freq_est 1
    spelled out, and the default with the --freq e initialisation."""
    rng = np.random.default_rng(3)
    S, N = 50, 4
    geno = tmp_path / "in.geno"
    rng.dirichlet(np.ones(3), size=(S, N)).astype("<f8").tofile(geno)
    pos = tmp_path / "in.pos"
    pos.write_text("".join(f"chr1\t{5000 * (s + 1)}\n" for s in range(S)))
    ok = _run(["--geno", str(geno), "--pos", str(pos), "--n_ind", str(N),
               "--n_sites", str(S), "--indF", "0.1-0.05", "--min_iters", "2",
               "--max_iters", "3", "--out", str(tmp_path / "run"),
               "--device", "cpu", "--dtype", "float32", "--kernel",
               "pallas"] + flags, module=True)
    assert ok.returncode == 0, ok.stderr
    assert "Final logLkl" in ok.stdout
    assert "Estimating allele frequencies" in ok.stdout
    assert "Alelle frequencies not estimated" not in ok.stdout
    assert ("Estimating initial frequency values assuming HWE"
            in ok.stdout) == ("e" in flags)
    lines = (tmp_path / "run.indF").read_text().splitlines()
    assert len(lines) == 1 + N + S
    freqs = np.array([float(x) for x in lines[1 + N:]])
    assert np.all(np.isfinite(freqs)) and np.ptp(freqs) > 0
    assert (tmp_path / "run.geno").stat().st_size == S * N * 3 * 8
    assert len((tmp_path / "run.ibd").read_text().splitlines()) > 0
