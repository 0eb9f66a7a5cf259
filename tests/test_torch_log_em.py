"""The scan tier as a whole (CPU, the kernels' plain versions, float64):
ngsf_hmm_tpu_torch.models.em with numerics "log" (the default) against
the JAX package's em_iteration / run_em with numerics "log" (its default
tier), the flattened restart iteration against the JAX em_iteration per
replicate, and the port's CLI with no --dtype / --kernel against the JAX
CLI's default, at S = 300, N = 6 with chromosome breaks.

Every JAX em_iteration here is called as run_em calls it (RUN_EM_KW), so
the whole file compiles one first-iteration shape (plus run_em's warm
one, with the L-BFGS memory).

Tolerances: one iteration's freq rtol 1e-9 and p_ibd atol 1e-9, F and
alpha after the M-step rtol 1e-8 (the blocked chain's float64 rounding
differs from the scan's, and the L-BFGS endpoints follow it); run_em's
n_iters equal, tot_lkl rtol 1e-9, Viterbi paths equal; the CLI's stdout
equal apart from the digits of the log-likelihoods and epsilons, the
time fields and the package tag, its .ibd paths equal, its .ibd
posteriors, .indF F / alpha / freq within one unit of their printed last
digit, its .indF header rtol 1e-9 and its .geno atol 1e-9.
"""

import contextlib
import io
import os
import re
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oracle
from ngsf_hmm_tpu.models import em as j_em
from ngsf_hmm_tpu.ops import haplo as j_haplo
from ngsf_hmm_tpu.ops import maf as j_maf
from ngsf_hmm_tpu.ops.emissions import calc_emission as j_calc_emission
from ngsf_hmm_tpu.ops.hwe import calc_hwe as j_calc_hwe
from ngsf_hmm_tpu.ops.hwe import post_prob as j_post_prob
from ngsf_hmm_tpu.tools.simulate import simulate
from test_torch_maf import observed
from ngsf_hmm_tpu_torch import convert
from ngsf_hmm_tpu_torch.models import em as t_em
from ngsf_hmm_tpu_torch.models import restart as t_restart

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

S, N = 300, 6
LOOP = dict(min_iters=3, max_iters=4, min_epsilon=100.0, verbose=0)
# the keywords JAX run_em passes to em_iteration on its first iteration
RUN_EM_KW = dict(freq_est=1, e_prob_calc=1, indF_fixed=False,
                 alpha_fixed=False, block_size=None, numerics="log",
                 gl_tiles=None, opt_memory=None, return_opt=True,
                 defer_emissions=False, defer_posteriors=False,
                 gl_bf16=False)


def _state(rng, gl):
    """A JAX float64 init state and its arrays."""
    freq = rng.uniform(0.05, 0.45, S)
    F, alpha = rng.uniform(0.05, 0.6, N), rng.uniform(0.01, 0.3, N)
    st = j_em.init_state(jnp.asarray(gl), jnp.asarray(freq), jnp.asarray(F),
                         jnp.asarray(alpha))
    return st, {k: np.array(getattr(st, k)) for k in convert.STATE_FIELDS}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(43)
    gl, _, dist, _, _, _ = oracle.random_case(rng, S=S, N=N,
                                              chrom_break_every=113)
    gl = np.ascontiguousarray(np.transpose(gl, (1, 0, 2)))  # [S, N, 3]
    st_j, arrays = _state(rng, gl)
    st2_j, arrays2 = _state(rng, gl)
    return dict(gl=gl, dist=dist, st_j=st_j, arrays=arrays, st2_j=st2_j,
                arrays2=arrays2, gl_t=torch.as_tensor(gl),
                dist_t=torch.as_tensor(dist))


@pytest.fixture(scope="module")
def iteration(case):
    """One JAX em_iteration (the file's compilation) and the port's."""
    out_j = j_em.em_iteration(jnp.asarray(case["gl"]),
                              jnp.asarray(case["dist"]), case["st_j"],
                              **RUN_EM_KW)
    st_t = convert.state_from_jax(case["arrays"], device="cpu")
    out_t = t_em.em_iteration(case["gl_t"], case["dist_t"], st_t,
                              return_opt=True)
    return out_j, out_t, st_t


def _close_state(got, want, cols=slice(None)):
    for k in ("freq", "p_ibd", "indF", "alpha", "ind_lkl", "e_prob"):
        observed(f"log em_iteration {k}", getattr(got, k),
                 np.asarray(getattr(want, k)))
    np.testing.assert_allclose(got.freq.numpy(), np.asarray(want.freq),
                               rtol=1e-9)
    np.testing.assert_allclose(got.p_ibd[:, cols].numpy(),
                               np.asarray(want.p_ibd), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.indF[cols].numpy(), np.asarray(want.indF),
                               rtol=1e-8)
    np.testing.assert_allclose(got.alpha[cols].numpy(),
                               np.asarray(want.alpha), rtol=1e-8)
    np.testing.assert_allclose(got.ind_lkl[cols].numpy(),
                               np.asarray(want.ind_lkl), rtol=1e-10)
    np.testing.assert_allclose(got.e_prob[:, cols].numpy(),
                               np.asarray(want.e_prob), rtol=1e-8,
                               atol=1e-9)


def test_em_iteration_matches_jax(iteration):
    """freq_est 1, e_prob_calc 1: the E-step on the chain, the L-BFGS
    M-step on the analytic gradient, est_maf in log space, calc_emission."""
    (sj, stat_j, mem_j), (st, stat, mem), st0 = iteration
    assert st.freq.dtype == torch.float64 and st.e_prob.shape == (S, N, 2)
    _close_state(st, sj)
    assert stat.opt_iters == int(stat_j.opt_iters)
    np.testing.assert_allclose(float(stat.fwbw_maxdiff),
                               float(stat_j.fwbw_maxdiff), rtol=1e-3,
                               atol=1e-12)
    # the M-step's memory: the same pairs stored, rows of the same shape
    assert mem[0].shape == (t_em.MVAL, N, 2)
    assert torch.equal(mem[2], torch.as_tensor(np.array(mem_j[2])))
    assert torch.equal(mem[3], torch.as_tensor(np.array(mem_j[3])))


def test_em_iteration_ld_modes_match_jax(case, iteration):
    """freq_est 2 with e_prob_calc 2 on the scan tier: the same E-step and
    M-step as freq_est 1 (bit for bit), then the two-site haplotype EM
    (JAX em.py:589-620, here its eager JAX functions on the JAX E-step's
    posterior, so that no second em_iteration is compiled)."""
    (sj, _, _), (st1, _, _), st0 = iteration
    st, _ = t_em.em_iteration(case["gl_t"], case["dist_t"], st0, freq_est=2,
                              e_prob_calc=2)
    for k in ("p_ibd", "indF", "alpha", "ind_lkl"):
        assert torch.equal(getattr(st, k), getattr(st1, k)), k

    @jax.jit
    def ld_step(gl, f0, p):
        pp = j_post_prob(gl, j_calc_hwe(f0[:, None], p))
        hap = j_haplo.haplo_freq(pp[:-1], pp[1:], f0[:-1], f0[1:],
                                 compat=False)
        freq = jnp.concatenate([j_maf.est_maf(gl[0:1], p[0:1]),
                                hap[:, 1] + hap[:, 3]])
        e_rest = jnp.stack([j_haplo.calc_emission_ld(
            hap[:, None, :], gl[:-1], gl[1:], freq[:-1, None], k)
            for k in (0, 1)], axis=-1)
        return freq, jnp.concatenate(
            [j_calc_emission(gl[0:1], freq[0:1, None]), e_rest])

    freq, e_prob = ld_step(jnp.asarray(case["gl"]), case["st_j"].freq,
                           sj.p_ibd)
    observed("log freq_est 2 freq", st.freq, np.asarray(freq))
    observed("log e_prob 2 e_prob", st.e_prob, np.asarray(e_prob))
    np.testing.assert_allclose(st.freq.numpy(), np.asarray(freq), rtol=1e-8)
    np.testing.assert_allclose(st.e_prob.numpy(), np.asarray(e_prob),
                               rtol=1e-8, atol=1e-9)
    # e_prob_calc 0 with freq_est 1 recomputes site 0's emission only
    st0b, _ = t_em.em_iteration(case["gl_t"], case["dist_t"], st0,
                                e_prob_calc=0)
    assert torch.equal(st0b.e_prob[1:], st0.e_prob[1:])
    assert torch.equal(st0b.e_prob[0], st1.e_prob[0])


def test_flattened_restart_iteration_matches_jax(case):
    """R = 2 replicates flattened into 2 N columns through one port
    em_iteration, against the JAX em_iteration run once per replicate
    state (the same compilation)."""
    gl, dist = jnp.asarray(case["gl"]), jnp.asarray(case["dist"])
    outs_j = [j_em.em_iteration(gl, dist, case[k], **RUN_EM_KW)
              for k in ("st_j", "st2_j")]
    stacked = convert.state_from_jax(
        {k: np.stack([case["arrays"][k], case["arrays2"][k]])
         for k in convert.STATE_FIELDS}, device="cpu")
    flat = t_restart.flatten_states(stacked)
    st, stat, mem = t_em.em_iteration(case["gl_t"], case["dist_t"], flat,
                                      n_rep=2, return_opt=True)
    assert st.freq.shape == (2, S) and stat.fwbw_maxdiff.shape == (2,)
    for r, (sj, stat_j, _) in enumerate(outs_j):
        cols = slice(r * N, (r + 1) * N)
        rep = t_restart.take_replicate(st, r)
        _close_state(rep, sj)
        assert torch.equal(rep.e_prob, st.e_prob[:, cols])
        np.testing.assert_allclose(float(stat.fwbw_maxdiff[r]),
                                   float(stat_j.fwbw_maxdiff), rtol=1e-3,
                                   atol=1e-12)
    assert mem[0].shape == (t_em.MVAL, 2 * N, 2)


@pytest.fixture(scope="module")
def runs(case):
    st_t = convert.state_from_jax(case["arrays"], device="cpu")
    rj = j_em.run_em(jnp.asarray(case["gl"]), jnp.asarray(case["dist"]),
                     case["st_j"], j_em.EMOptions(**LOOP))
    rt = t_em.run_em(case["gl"], case["dist"], st_t, t_em.EMOptions(**LOOP),
                     device="cpu")
    return rj, rt


def test_run_em_matches_jax(runs):
    rj, rt = runs
    assert rt.n_iters == rj.n_iters == 3
    observed("log run_em tot_lkl", rt.tot_lkl, rj.tot_lkl)
    np.testing.assert_allclose(rt.tot_lkl, rj.tot_lkl, rtol=1e-9)
    np.testing.assert_allclose(rt.lkl_history, rj.lkl_history, rtol=1e-9)
    assert np.array_equal(rt.path, np.asarray(rj.path))
    sj, st = rj.state, rt.state
    for k in ("freq", "indF", "alpha", "p_ibd"):
        observed(f"log run_em {k}", getattr(st, k),
                 np.asarray(getattr(sj, k)))
    np.testing.assert_allclose(st.indF.numpy(), np.asarray(sj.indF),
                               rtol=1e-7)
    np.testing.assert_allclose(st.alpha.numpy(), np.asarray(sj.alpha),
                               rtol=1e-7)
    np.testing.assert_allclose(st.freq.numpy(), np.asarray(sj.freq),
                               rtol=1e-7)
    # the JAX run_em carries the M-step memory across iterations: so does
    # the port's, in float64
    assert len(rt.opt_iters) == 3 and rt.opt_memory[0].dtype == torch.float64


ARGS = ("--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 6 "
        "--n_sites 300 --freq e --indF r --seed 7 --min_iters 3 "
        "--max_iters 4 --min_epsilon 100").split()


def _main(main, args, cwd):
    cwd.mkdir()
    for f in ("sim.glf.gz", "sim.pos.gz"):
        shutil.copy(cwd.parent / f, cwd / f)
    old, buf = os.getcwd(), io.StringIO()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(buf):
            rc = main(args)
    finally:
        os.chdir(old)
    assert rc == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Both CLIs on one simulated input (two chromosomes), their default
    tiers: the JAX package's in this process, the port's with --device
    cpu only."""
    from ngsf_hmm_tpu.cli import main as j_main
    from ngsf_hmm_tpu_torch.cli import main as t_main

    d = tmp_path_factory.mktemp("log_cli")
    simulate(n_ind=N, n_sites=S, freq="0.2", site_pos="r", indF="0.5",
             alpha="0.05", depth="2", error=0.01, seed=17, n_chr=2,
             out=str(d / "sim"))
    out_j = _main(j_main, ARGS + ["--out", "run"], d / "jax")
    out_t = _main(t_main, ARGS + ["--out", "run", "--device", "cpu"],
                  d / "port")
    return d, out_j, out_t


def _masked(text):
    """stdout with the package tag, the time fields and the digits of the
    log-likelihoods and epsilons masked."""
    lines = []
    for line in text.splitlines():
        line = re.sub(r"\((tpu|torch)\)", "(package)", line)
        line = re.sub(r"time: \d+ \(s\)", "time: # (s)", line)
        if re.search(r"[Ll]og[Ll]kl|epsilon", line):
            line = re.sub(r"[-+]?\d+\.\d+", "#", line)
        lines.append(line)
    return lines


def test_cli_default_tier_stdout_matches_jax(cli):
    d, out_j, out_t = cli
    assert "Final logLkl" in out_t
    assert _masked(out_t) == _masked(out_j)
    assert re.search(r"LogLkl: -\d+\.\d+", out_t)  # the masked fields exist


def test_cli_default_tier_outputs_match_jax(cli):
    d = cli[0]
    ibd_j = (d / "jax" / "run.ibd").read_text().splitlines()
    ibd_t = (d / "port" / "run.ibd").read_text().splitlines()
    assert len(ibd_t) == len(ibd_j) == 1 + 2 * N
    assert ibd_t[1:1 + N] == ibd_j[1:1 + N]  # the Viterbi paths
    for a, b in zip(ibd_t[1 + N:], ibd_j[1 + N:]):
        np.testing.assert_allclose(np.array(a.split(), float),
                                   np.array(b.split(), float), atol=1.01e-6)
    ind_j = (d / "jax" / "run.indF").read_text().splitlines()
    ind_t = (d / "port" / "run.indF").read_text().splitlines()
    assert len(ind_t) == len(ind_j) == 1 + N + S
    np.testing.assert_allclose(float(ind_t[0]), float(ind_j[0]), rtol=1e-9)
    for a, b in zip(ind_t[1:], ind_j[1:]):
        va, vb = a.split(), b.split()
        assert len(va) == len(vb) and ("NA" in va) == ("NA" in vb)
        np.testing.assert_allclose(
            [float(x) for x in va if x != "NA"],
            [float(x) for x in vb if x != "NA"], atol=1.01e-5)
    geno_j = np.fromfile(d / "jax" / "run.geno", "<f8")
    geno_t = np.fromfile(d / "port" / "run.geno", "<f8")
    assert geno_t.size == geno_j.size == S * N * 3
    np.testing.assert_allclose(geno_t, geno_j, rtol=0, atol=1e-9)


def test_scan_tier_is_the_default_and_refuses_what_it_lacks(case):
    """The scan tier is the default (float64, as the JAX CLI's --dtype);
    a float32 state runs on it too, on the float32 kernels'
    plain versions; replicates in the LD modes pass its refusals; what it
    still lacks (the blocked and linear tiers, block_size, any other float
    type) is refused, naming the ROADMAP item."""
    from ngsf_hmm_tpu_torch.cli import parse_args

    assert t_em.EMOptions().numerics == j_em.EMOptions().numerics == "log"
    p = parse_args(["--geno", "g"])
    assert (p["dtype"], p["kernel"]) == ("float64", "scan")
    a = case["arrays"]
    st = t_em.init_state(case["gl"], a["freq"], a["indF"], a["alpha"],
                         device="cpu")  # gl's float64
    assert st.e_prob.dtype == torch.float64
    st32 = t_em.init_state(case["gl"], a["freq"], a["indF"], a["alpha"],
                           device="cpu", dtype=torch.float32)
    out, _ = t_em.em_iteration(case["gl_t"].float(), case["dist_t"].float(),
                               st32)
    assert all(getattr(out, k).dtype == torch.float32
               for k in convert.STATE_FIELDS)
    assert t_em.TIER_DTYPES["log"] == (torch.float64, torch.float32)
    for kw in (dict(freq_est=2), dict(e_prob_calc=2), dict(e_prob_calc=0)):
        t_em._refuse(n_rep=2, **kw)
    for kw in (dict(numerics="linear"), dict(block_size=64)):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1: 'models/hmm_blocked.py'"):
            t_em._refuse(**kw)
    with pytest.raises(TypeError, match="float64 or float32"):
        t_em._refuse(dtype=torch.bfloat16)
    sts = t_restart.stack_restart_states(case["gl"], 2, 5, device="cpu")
    assert sts.e_prob.dtype == torch.float64 and sts.e_prob.shape[0] == 2


def test_fused_tier_refuses_a_float64_state(case):
    """The fused tier's float types are models/em.TIER_DTYPES': a float64
    state (init_state's default from a float64 gl) is no longer refused
    there but runs, as in the JAX package, on the float32 kernels, every
    entry point keeping it float64 (tests/test_torch_fused64.py holds it
    against JAX); a bfloat16 state is refused."""
    a = case["arrays"]
    st = t_em.init_state(case["gl"], a["freq"], a["indF"], a["alpha"],
                         device="cpu")
    assert t_em.TIER_DTYPES["pallas"] == (torch.float32, torch.float64)
    opts = t_em.EMOptions(numerics="pallas", min_iters=1, max_iters=2,
                          min_epsilon=100.0, verbose=0)
    out, _ = t_em.em_iteration(case["gl_t"], case["dist_t"], st,
                               numerics="pallas")
    res = t_em.run_em(case["gl"], case["dist"], st, opts, device="cpu")
    sts = t_restart.stack_restart_states(case["gl"], 2, 5, device="cpu")
    rres = t_restart.run_em_restarts(case["gl"], case["dist"], sts, opts,
                                     device="cpu")
    for state in (out, res.state, rres.best.state):
        assert all(getattr(state, k).dtype == torch.float64
                   for k in convert.STATE_FIELDS)
    with pytest.raises(TypeError, match="float64 or float32"):
        t_em.em_iteration(case["gl_t"].bfloat16(), case["dist_t"],
                          st._replace(indF=st.indF.bfloat16()),
                          numerics="pallas")


@pytest.mark.parametrize("extra, msg", [
    (["--kernel", "linear"], "'models/hmm_blocked.py'"),
    (["--kernel", "blocked"], "'models/hmm_blocked.py'"),
    (["--gl_bf16", "1"], "requires --kernel pallas"),
    (["--kernel", "pallas", "--n_rep", "2", "--e_prob", "0"],
     "'models/hmm_blocked.py'"),
    (["--opt", "compat"], "'--opt compat'"),
], ids=["linear", "blocked", "gl_bf16-scan", "pallas-n_rep-e_prob0",
        "opt-compat"])
def test_cli_refuses_on_the_scan_tier(extra, msg, capsys):
    """What the CLI still refuses names what will lift it (in-process: the
    refusal comes before the files are opened): the blocked and linear
    tiers, bfloat16 slabs off the fused tier, the fused tier's LD
    replicates and --opt compat. --dtype float32, --kernel pallas in
    float64 and the scan tier's LD replicates now run
    (tests/test_torch_log32.py, test_torch_fused64.py,
    test_torch_log_ld_restart.py)."""
    from ngsf_hmm_tpu_torch.cli import main

    base = ["--geno", "none.geno", "--pos", "none.pos", "--n_ind", "4",
            "--n_sites", "50", "--out", "none", "--verbose", "0",
            "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        main(base + extra)
    assert exc.value.code != 0
    assert msg in capsys.readouterr().err
