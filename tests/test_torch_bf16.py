"""bfloat16 gl slabs in the port (EMOptions.gl_bf16, --gl_bf16 1) against
the JAX package's bf16 tier, on the CPU through the kernels' plain
versions, with inputs made by numpy from fixed seeds.

Only the stored gl is quantised (about 2^-9 relative): every kernel and
plain version upcasts at load and computes in float32. So where both sides
read the same bfloat16 slabs, the gates are the float32 tier's kernel
gates (posteriors atol 2e-5, log-likelihoods rtol 2e-6, freq atol 2e-5);
where a bfloat16 run is held against a float32 one, the gates are the JAX
package's input-noise envelopes (tests/test_bf16.py: freq atol 3e-3,
ind_lkl rtol 5e-4).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ngsf_hmm_tpu.models import em as j_em
from ngsf_hmm_tpu.models import hmm_pallas as hp
from ngsf_hmm_tpu.ops import maf_pallas as j_mp
from ngsf_hmm_tpu_torch import convert
from ngsf_hmm_tpu_torch.models import em as t_em
from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
from ngsf_hmm_tpu_torch.utils.cuda_lib import PLAIN_CALLS
from test_torch_maf import observed, realistic_gls
from test_torch_package import _run

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

bf16 = torch.bfloat16
# the gl-slab kernels; on a bfloat16 run each counts under name + "_bf16"
GL_KERNELS = ("block_transfer_grad", "bw_sites", "fw_post")


def _case(seed, S, N, breaks=0):
    """Linear GLs [S, N, 3], distances [S] (inf every `breaks` sites),
    freq [S], F / alpha [N], float32."""
    rng = np.random.default_rng(seed)
    gl = realistic_gls(rng, S, N).astype(np.float32)
    dist = rng.uniform(1e-3, 0.05, S).astype(np.float32)
    if breaks:
        dist[breaks::breaks] = np.inf
    return (gl, dist, rng.uniform(0.05, 0.45, S).astype(np.float32),
            rng.uniform(0.05, 0.6, N).astype(np.float32),
            rng.uniform(0.02, 0.3, N).astype(np.float32))


def _state(gl, freq, F, alpha):
    """The same initial state on both sides (JAX init_state, copied)."""
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    st_j = j_em.init_state(jnp.asarray(np.log(gl)), f32(freq), f32(F),
                           f32(alpha))
    arrays = {k: np.array(getattr(st_j, k)) for k in convert.STATE_FIELDS}
    return st_j, convert.state_from_jax(arrays, device="cpu")


def test_bf16_slabs_equal_jax_bits():
    """prepare_gl_inputs(gl_dtype=bfloat16): the slabs are bfloat16 and,
    unpacked to [S, N], equal JAX prepare_gl_inputs(gl_dtype=bfloat16)'s
    unpacked slabs bit for bit (both pad and lay out in float32, then
    round to nearest even once); the dist compact stays float32 and the
    float32 slabs round to the bfloat16 ones."""
    S, N = 407, 11
    gl, dist, _, _, _ = _case(11, S, N, breaks=100)
    tp = hk.prepare_gl_inputs(torch.as_tensor(gl), torch.as_tensor(dist),
                              gl_dtype=bf16)
    jp = hp.prepare_gl_inputs(jnp.asarray(gl), jnp.asarray(dist),
                              gl_dtype=jnp.bfloat16)
    assert tp["g0"].dtype == tp["g2"].dtype == bf16
    assert tp["dc"].dtype == torch.float32
    f32 = hk.prepare_gl_inputs(torch.as_tensor(gl), torch.as_tensor(dist))
    for ch in ("g0", "g2"):
        got = hk._unpack_sites2(tp[ch], tp)
        want = np.asarray(hp._unpack_sites2(jp[ch], jp))
        assert got.shape == want.shape == (S, N)
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(), want.view(np.int16))
        assert torch.equal(tp[ch], f32[ch].to(bf16))
        # the pad cells hold 1/3 in bfloat16
        pads = tp[ch].transpose(0, 1).reshape(-1, N)[S:]
        assert torch.equal(pads, torch.full_like(pads, 1.0 / 3.0))


def test_posteriors_fused_bf16_matches_jax():
    """posteriors_fused on bfloat16 slabs against JAX
    hmm_pallas.posteriors_fused on bfloat16 slabs in interpret mode (S =
    333 with chromosome breaks and a ragged last block, N = 5):
    posteriors atol 2e-5, log-likelihoods rtol 2e-6. The grad kernel's
    primal rows equal the transfer kernel's on bfloat16 too, and every
    chain function ran its bfloat16 version."""
    S, N = 333, 5
    gl, dist, freq, F, alpha = _case(333, S, N, breaks=101)
    jp = hp.prepare_gl_inputs(jnp.asarray(gl), jnp.asarray(dist),
                              gl_dtype=jnp.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        # 8 rows a grid step keep the interpret-mode trace short
        mp.setenv("NGSF_PALLAS_R", "8")
        pj, lfj, lbj = hp.posteriors_fused(
            jnp.asarray(F), jnp.asarray(alpha), jp,
            hp.freq_compact(jnp.asarray(freq), jp))
    prep = hk.prepare_gl_inputs(torch.as_tensor(gl), torch.as_tensor(dist),
                                gl_dtype=bf16)
    fc = hk.freq_compact(torch.as_tensor(freq), prep)
    Ft, at = torch.as_tensor(F), torch.as_tensor(alpha)
    before = dict(PLAIN_CALLS)
    A_g, A_reps = hk.transfer_grad_reps_fused(Ft, at, prep, fc)
    p, ll_f, ll_b = hk.posteriors_fused(Ft, at, prep, fc, A_reps=A_reps)
    observed("posteriors_fused bf16 vs JAX bf16", p, pj)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=2e-5)
    np.testing.assert_allclose(ll_f.numpy(), np.asarray(lfj), rtol=2e-6)
    np.testing.assert_allclose(ll_b.numpy(), np.asarray(lbj), rtol=2e-6)
    A_r, _ = hk.block_transfers_fused(Ft[None], at[None], prep, fc)
    assert torch.equal(A_reps[0], A_r)
    for k in GL_KERNELS + ("block_transfer",):
        assert PLAIN_CALLS[k + "_bf16"] > before.get(k + "_bf16", 0)
        assert PLAIN_CALLS[k] == before.get(k, 0)


def test_est_maf_slab_bf16_matches_jax():
    """est_maf_slab on bfloat16 slabs against JAX maf_pallas.est_maf_slab
    on bfloat16 slabs (kernels A and B in interpret mode), S = 500, N =
    40, one posterior packed on each side: freq atol 2e-5. macro_slab on
    the same slabs agrees too."""
    S, N = 500, 40
    gl, _, _, _, _ = _case(500, S, N)
    p = np.random.default_rng(5).random((S, N)).astype(np.float32)
    jp = hp.prepare_gl_inputs(jnp.asarray(gl), jnp.zeros(S),
                              gl_dtype=jnp.bfloat16)
    want = np.asarray(j_mp.est_maf_slab(jp, hp.pack_sites2(jnp.asarray(p),
                                                           jp)))
    tp = hk.prepare_gl_inputs(torch.as_tensor(gl), torch.zeros(S),
                              gl_dtype=bf16)
    slab = hk.pack_sites2(torch.as_tensor(p), tp)
    calls = PLAIN_CALLS["maf_state_grad_bf16"]
    got = mk.est_maf_slab(tp, slab)
    assert PLAIN_CALLS["maf_state_grad_bf16"] == calls + 1
    observed("est_maf_slab bf16 vs JAX est_maf_slab bf16", got, want)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(mk.macro_slab(tp, slab).numpy(), want,
                               atol=2e-5)


def test_em_iteration_gl_bf16_matches_jax():
    """One em_iteration with gl_bf16=True and (F, alpha) fixed on both
    sides against JAX em_iteration(numerics="pallas", gl_bf16=True)
    (S = 300, N = 40, a chromosome break; the JAX side in interpret
    mode): freq atol 2e-5. The threaded slabs are bfloat16 and the
    iteration ran the bfloat16 versions only."""
    S, N = 300, 40
    gl, dist, _, _, _ = _case(402, S, N)
    dist[150] = np.inf
    st_j, st_t = _state(gl, np.full(S, 0.2), np.full(N, 0.3),
                        np.full(N, 0.05))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NGSF_PALLAS_R", "8")  # short interpret-mode trace
        sj, _ = j_em.em_iteration(
            jnp.asarray(np.log(gl)), jnp.asarray(dist), st_j,
            numerics="pallas", indF_fixed=True, alpha_fixed=True,
            gl_bf16=True)
    before = dict(PLAIN_CALLS)
    st, stats, slabs = t_em.em_iteration(
        torch.as_tensor(np.log(gl)), torch.as_tensor(dist), st_t,
        numerics="pallas", indF_fixed=True, alpha_fixed=True, gl_bf16=True,
        return_prep=True)
    assert float(stats.fwbw_maxdiff) < 1e-3
    assert len(slabs) == 3 and slabs[0].dtype == slabs[1].dtype == bf16
    observed("em_iteration gl_bf16 freq", st.freq, sj.freq)
    np.testing.assert_allclose(st.freq.numpy(), np.asarray(sj.freq),
                               atol=2e-5)
    ran = {k: v - before.get(k, 0) for k, v in PLAIN_CALLS.items()
           if v != before.get(k, 0)}
    # (F, alpha) fixed: the transfer kernel, not the grad one, streams
    for k in ("block_transfer", "bw_sites", "fw_post", "maf_state_grad",
              "maf_sums_grad"):
        assert ran.get(k + "_bf16", 0) >= 1 and k not in ran, ran


def test_run_em_bf16_close_to_float32():
    """run_em with EMOptions(gl_bf16=True) against the same run in float32
    (the data of tests/test_bf16.py's shape: 2000 x 40, three
    iterations, from freq 0.2): freq atol 3e-3 and ind_lkl rtol 5e-4, the
    JAX package's bf16 envelopes (tests/test_bf16.py:87, :111-114); the
    same number of iterations."""
    S, N = 2000, 40
    gl, dist, _, _, _ = _case(91, S, N)
    _, st_t = _state(gl, np.full(S, 0.2), np.linspace(0.1, 0.6, N),
                     np.linspace(0.02, 0.2, N))
    res = {}
    for b in (False, True):
        opts = t_em.EMOptions(numerics="pallas", min_iters=2, max_iters=3,
                              verbose=0,
                              gl_bf16=b)
        res[b] = t_em.run_em(np.log(gl), dist, st_t, opts, device="cpu")
    assert res[True].n_iters == res[False].n_iters == 3
    a, b = res[False].state, res[True].state
    assert b.freq.dtype == torch.float32
    observed("run_em bf16 vs float32 freq", b.freq, a.freq)
    np.testing.assert_allclose(b.freq.numpy(), a.freq.numpy(), atol=3e-3)
    np.testing.assert_allclose(b.ind_lkl.numpy(), a.ind_lkl.numpy(),
                               rtol=5e-4)
    assert np.isfinite(b.p_ibd.numpy()).all()


def test_exact_route_reads_float32_gl():
    """Below 32 individuals (no macro schedule) the freq M-step reads
    float32 gl under gl_bf16, as the JAX package's _run reads float32
    tiles: with the bfloat16 E-step's posterior, the freq equals bit for
    bit what the float32 route's M-step (est_maf_exact on float32 slabs)
    gives, while the chain kernels read bfloat16 (S = 307, N = 8)."""
    S, N = 307, 8
    gl, dist, freq, F, alpha = _case(21, S, N)
    _, st_t = _state(gl, freq, F, alpha)
    gl_t, dist_t = torch.as_tensor(np.log(gl)), torch.as_tensor(dist)
    before = dict(PLAIN_CALLS)
    st, _, slabs = t_em.em_iteration(
        gl_t, dist_t, st_t, numerics="pallas", indF_fixed=True,
        alpha_fixed=True, gl_bf16=True, return_prep=True,
        defer_posteriors=True)
    assert PLAIN_CALLS["maf_exact"] == before.get("maf_exact", 0) + 1
    assert PLAIN_CALLS["fw_post_bf16"] == before.get("fw_post_bf16", 0) + 1
    p32 = hk.prepare_gl_inputs(torch.exp(gl_t), dist_t)
    assert [s.dtype for s in slabs] == [bf16, bf16] + [torch.float32] * 3
    assert torch.equal(slabs[3], p32["g0"]) and torch.equal(slabs[4],
                                                            p32["g2"])
    p16 = hk.make_prep2(*slabs[:3], S, N, p32["bs"], p32["nb"])
    _, _, _, slab = hk.posteriors_fused(
        st_t.indF, st_t.alpha, p16, hk.freq_compact(st_t.freq, p16),
        return_slab=True)
    assert torch.equal(st.freq, mk.est_maf_exact(p32, slab))
    # a threaded iteration keeps all five
    st2, _, slabs2 = t_em.em_iteration(
        gl_t, dist_t, st, numerics="pallas", indF_fixed=True,
        alpha_fixed=True, gl_bf16=True, prep_slabs=slabs, return_prep=True)
    assert all(a is b for a, b in zip(slabs, slabs2))
    assert torch.isfinite(st2.freq).all()


def test_gl_dtype_checks():
    """The gl kernels take g0 / g2 both float32 or both bfloat16 (their
    argument checks, which run before a launch, raise on anything else);
    the exact est_maf kernel reads float32 gl only, on every device."""
    S, N = 40, 4
    gl, dist, freq, F, alpha = _case(4, S, N)
    prep = hk.prepare_gl_inputs(torch.as_tensor(gl), torch.as_tensor(dist),
                                gl_dtype=bf16)
    fc = hk.freq_compact(torch.as_tensor(freq), prep)
    g0, g2 = prep["g0"], prep["g2"]
    args = (fc, prep["dc"], torch.as_tensor(F), torch.as_tensor(alpha))
    for bad in ((g0, g2.float()), (g0.half(), g2.half())):
        with pytest.raises(TypeError, match="both float32 or both bfloat16"):
            hk._check_stream_args("bw_sites", *bad, *args)
        with pytest.raises(TypeError, match="both float32 or both bfloat16"):
            mk._check_slabs("maf_state_grad", *bad, torch.rand(g0.shape))
    slab = torch.rand(g0.shape)
    with pytest.raises(TypeError, match="maf_exact reads float32 gl"):
        mk.est_maf_exact(prep, slab)


def test_cli_gl_bf16_on_cpu(tmp_path):
    """python -m ngsf_hmm_tpu_torch --gl_bf16 1 --device cpu (S = 300, N
    = 33: the slab est_maf route) writes its three files; --gl_bf16 2 is
    an error."""
    S, N = 300, 33
    gl, _, _, _, _ = _case(33, S, N)
    geno = tmp_path / "in.geno"
    gl.astype("<f8").tofile(geno)
    pos = tmp_path / "in.pos"
    pos.write_text("".join(f"chr1\t{5000 * (s + 1)}\n" for s in range(S)))
    base = ["--geno", str(geno), "--pos", str(pos), "--n_ind", str(N),
            "--n_sites", str(S), "--freq", "e", "--indF", "0.1-0.05",
            "--min_iters", "2", "--max_iters", "3", "--device", "cpu",
            "--dtype", "float32", "--kernel", "pallas",
            "--out", str(tmp_path / "run")]
    ok = _run(base + ["--gl_bf16", "1"], module=True)
    assert ok.returncode == 0, ok.stderr
    assert "Final logLkl" in ok.stdout
    assert (tmp_path / "run.geno").stat().st_size == S * N * 3 * 8
    lines = (tmp_path / "run.indF").read_text().splitlines()
    assert len(lines) == 1 + N + S
    vals = [float(x) for line in lines for x in line.split() if x != "NA"]
    assert np.isfinite(vals).all()
    assert len((tmp_path / "run.ibd").read_text().splitlines()) > 0
    bad = _run(base + ["--gl_bf16", "2"], module=True)
    assert bad.returncode != 0 and "invalid --gl_bf16" in bad.stderr
