"""The slice as a whole: ngsf_hmm_tpu_torch.models.em.run_em (CPU, plain
versions of the kernels) against ngsf_hmm_tpu.models.em.run_em with
EMOptions(numerics="pallas", freq_est=0) (Pallas interpret mode), both in
float32 from one state carried across with convert.state_from_jax.

Tolerances: n_iters equal; tot_lkl rtol 1e-5; indF / alpha atol 2e-3 (the
two optimizers' endpoints agree to the shared PGTOL, not bit for bit:
float32 chains with different product association feed them); p_ibd atol
1e-3; Viterbi path mismatch <= 0.5% of cells.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from ngsf_hmm_tpu.models import em as j_em
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
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    st_j = j_em.init_state(jnp.asarray(gl), f32(freq), f32(F), f32(alpha))
    arrays = {k: np.array(getattr(st_j, k)) for k in convert.STATE_FIELDS}
    with pytest.MonkeyPatch.context() as mp:
        # the package's own sites-per-grid-step knob keeps the
        # interpret-mode trace of the jitted iteration short
        mp.setenv("NGSF_PALLAS_R", "8")
        res_j = j_em.run_em(
            jnp.asarray(gl), f32(dist), st_j,
            j_em.EMOptions(numerics="pallas", freq_est=0, **LOOP))
    st_t = convert.state_from_jax(arrays, device="cpu")
    res_t = t_em.run_em(gl, dist.astype(np.float32), st_t,
                        t_em.EMOptions(**LOOP), device="cpu")
    return dict(gl=gl, dist=dist, arrays=arrays, jax=res_j, port=res_t,
                st_t=st_t)


def test_state_from_jax_round_trip(runs):
    st = runs["st_t"]
    assert st.e_prob.shape == (S, N, 2) and st.e_prob.dtype == torch.float32
    back = convert.state_to_jax(st)
    for k in convert.STATE_FIELDS:
        assert np.array_equal(back[k], runs["arrays"][k], equal_nan=True)
    # the port's own init_state builds the same emissions (float32 exp/log
    # of two libraries: atol 1e-5 on log emissions)
    a = runs["arrays"]
    own = t_em.init_state(runs["gl"], a["freq"], a["indF"], a["alpha"],
                          device="cpu")
    np.testing.assert_allclose(own.e_prob.numpy(), a["e_prob"], atol=1e-5)


def test_run_em_matches_jax(runs):
    rj, rt = runs["jax"], runs["port"]
    assert rt.n_iters == rj.n_iters == 3
    assert rt.converged == rj.converged
    np.testing.assert_allclose(rt.tot_lkl, rj.tot_lkl, rtol=1e-5)
    np.testing.assert_allclose(rt.lkl_history, rj.lkl_history, rtol=1e-5)
    sj, st = rj.state, rt.state
    np.testing.assert_allclose(st.indF.numpy(), np.asarray(sj.indF),
                               atol=2e-3)
    np.testing.assert_allclose(st.alpha.numpy(), np.asarray(sj.alpha),
                               atol=2e-3)
    np.testing.assert_allclose(st.p_ibd.numpy(), np.asarray(sj.p_ibd),
                               atol=1e-3)
    np.testing.assert_allclose(st.ind_lkl.numpy(), np.asarray(sj.ind_lkl),
                               rtol=1e-5)
    # freq and the emissions are frozen under freq_est 0
    assert np.array_equal(st.freq.numpy(), runs["arrays"]["freq"])
    assert np.array_equal(st.e_prob.numpy(), runs["arrays"]["e_prob"])
    assert rt.path.shape == (S, N) and rt.path.dtype == np.int8
    assert np.mean(rt.path != np.asarray(rj.path)) <= 0.005


def test_run_em_invariants_and_memory(runs):
    rt = runs["port"]
    h = rt.lkl_history
    # freq is frozen, so EM is monotone up to float32 noise in the sum
    assert all(b >= a - 1e-4 * abs(a) for a, b in zip(h, h[1:]))
    assert len(rt.opt_iters) == 3
    mem = convert.opt_memory_to_jax(rt.opt_memory)
    assert mem[0].shape == (t_em.MVAL, N, 2) and mem[3].shape == (N,)
    back = convert.opt_memory_from_jax(mem, N, device="cpu")
    for a, b in zip(back, rt.opt_memory):
        assert torch.equal(a, b)
    assert convert.opt_memory_from_jax(mem, N + 1, device="cpu") is None
    # one more warm iteration from the carried memory runs
    out = t_em.em_iteration(
        torch.as_tensor(runs["gl"]), torch.as_tensor(runs["dist"]).float(),
        rt.state, opt_memory=back, return_opt=True)
    assert torch.isfinite(out[0].ind_lkl).all()
    assert float(out[1].fwbw_maxdiff) < 1e-3


@pytest.mark.parametrize("kw", [
    dict(freq_est=1), dict(freq_est=2), dict(e_prob_calc=2),
    dict(numerics="log"), dict(numerics="linear"), dict(block_size="auto"),
    dict(gl_bf16=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unsupported_options_raise(runs, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_em.run_em(runs["gl"], runs["dist"], runs["st_t"],
                    t_em.EMOptions(**LOOP, **kw), device="cpu")


def test_unsupported_iteration_arguments_raise(runs):
    gl = torch.as_tensor(runs["gl"])
    dist = torch.as_tensor(runs["dist"]).float()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_em.em_iteration(gl, dist, runs["st_t"], n_rep=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        a = runs["arrays"]
        t_em.init_state(runs["gl"], a["freq"], a["indF"], a["alpha"],
                        e_prob_calc=2, device="cpu")
