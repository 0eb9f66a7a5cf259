"""The row-layout est_maf of the port (the LD path's freq M-step) and the
one-launch slab est_maf (macro_slab, kernel 9) against the JAX package, on
the CPU.

ngsf_hmm_tpu_torch.ops.maf_kernels.est_maf_rows reads the linear gl planes
g0 / g2 [S, N] and the snapped posterior [S, N] as rows: with a macro
schedule (N >= 32) the whole schedule runs in maf_macro (here its plain
version, _macro_rows_plain), without one (N < 32) maf_exact runs on the
[S, 1, N] row view. Held against the JAX est_maf_pallas on tiles
(_run_macro / _run in Pallas interpret mode) and against XLA est_maf, in
float32, with inputs made by numpy from fixed seeds.

ngsf_hmm_tpu_torch.ops.maf_kernels.macro_slab runs the same kernel on the
[bs * nb, N] view of the gl slabs (float32 or bfloat16) and the raw
posterior slab; it is held against the JAX kernel _run_macro_slab in
interpret mode on the same values in the JAX layout.

Tolerance: freq atol 2e-5, the JAX package's pallas-vs-XLA gate
(tests/test_maf.py). The two sides differ in the order of the sum over
individuals, in the reciprocal (the TPU's approximate one with a Newton
step against 1 / D) and in g1 (a stored tile against 1 - g0 - g2).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ngsf_hmm_tpu.models import hmm_pallas as j_hp
from ngsf_hmm_tpu.ops import maf as j_maf
from ngsf_hmm_tpu.ops import maf_pallas as j_mp
from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
from ngsf_hmm_tpu_torch.ops import maf as t_maf
from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
from ngsf_hmm_tpu_torch.utils.cuda_lib import PLAIN_CALLS
from test_torch_maf import observed, realistic_gls

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)


def _case(seed, S, N):
    """Linear GLs [S, N, 3] and a snapped posterior [S, N] with exact 0s
    and 1s (the het floor's case), float32."""
    rng = np.random.default_rng(seed)
    gl = realistic_gls(rng, S, N).astype(np.float32)
    p = rng.random((S, N)).astype(np.float32)
    p[p < 0.1] = 0.0
    p[p > 0.9] = 1.0
    p[5, :] = 1.0
    return gl, p


def _rows(gl, p):
    g0 = torch.as_tensor(gl[..., 0]).contiguous()
    g2 = torch.as_tensor(gl[..., 2]).contiguous()
    return g0, g2, torch.as_tensor(p)


def test_macro_rows_plain_matches_pallas_run_macro():
    """_macro_rows_plain (the plain version of csrc/maf_macro.cu) against
    est_maf_pallas(prepare_gl_tiles(gl), p, S, macro=True) -- _run_macro
    in interpret mode -- at S = 700 (not a multiple of the 1024-site tile:
    the pads run), N = 40 (schedule (16, (8, 16, 32, 29))): atol 2e-5."""
    S, N = 700, 40
    gl, p = _case(700, S, N)
    g0, g2, pt = _rows(gl, p)
    K0, M = t_maf.macro_schedule(N)
    got = mk._macro_rows_plain(g0, g2, pt, K0, t_maf.macro_rounds(K0, M))
    assert got.shape == (S,) and got.dtype == torch.float32
    want = np.asarray(j_mp.est_maf_pallas(
        j_mp.prepare_gl_tiles(jnp.asarray(gl)), jnp.asarray(p), S,
        macro=True))
    observed("_macro_rows_plain vs est_maf_pallas (_run_macro)", got, want)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # the public function takes the same route on CPU tensors
    calls = PLAIN_CALLS["maf_macro"]
    assert torch.equal(mk.est_maf_rows(g0, g2, pt), got)
    assert PLAIN_CALLS["maf_macro"] == calls + 1


def test_macro_rows_above_128_matches_xla_macro():
    """At N = 130 (above 128 individuals, where the kernel recomputes its
    planes from cache) against XLA est_maf(linear=True, macro=True), not
    interpreted: atol 2e-5. The port's own ops/maf.est_maf(macro) agrees
    too."""
    S, N = 300, 130
    gl, p = _case(130, S, N)
    g0, g2, pt = _rows(gl, p)
    got = mk.est_maf_rows(g0, g2, pt)
    want = np.asarray(j_maf.est_maf(jnp.asarray(gl), jnp.asarray(p),
                                    linear=True, macro=True))
    observed("est_maf_rows vs XLA est_maf(macro), N = 130", got, want)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    own = t_maf.est_maf(torch.as_tensor(gl), pt, linear=True, macro=True)
    np.testing.assert_allclose(got.numpy(), own.numpy(), atol=2e-5)


@pytest.mark.parametrize("macro", [True, False], ids=["schedule", "exact"])
def test_rows_below_32_match_pallas_run(macro):
    """At N = 6 there is no schedule: est_maf_rows runs maf_exact on the
    [S, 1, N] row view without its snap (p is snapped already), against
    est_maf_pallas(..., macro) -- _run in interpret mode -- at S = 333:
    atol 2e-5. macro=False asks for the exact route outright."""
    S, N = 333, 6
    gl, p = _case(6, S, N)
    p[10] = 1.0 - 3e-6  # not snapped here: read as it is on both sides
    g0, g2, pt = _rows(gl, p)
    calls = PLAIN_CALLS["maf_exact"]
    got = mk.est_maf_rows(g0, g2, pt, macro=macro)
    assert PLAIN_CALLS["maf_exact"] == calls + 1
    assert got.shape == (S,) and got.dtype == torch.float32
    want = np.asarray(j_mp.est_maf_pallas(
        j_mp.prepare_gl_tiles(jnp.asarray(gl)), jnp.asarray(p), S,
        macro=macro))
    observed("est_maf_rows (maf_exact rows) vs est_maf_pallas (_run)", got,
             want)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_gl_rows_are_the_linear_planes():
    """gl_rows: exp of the log GLs' genotype 0 and 2 planes, contiguous
    float32 [S, N] (rtol 1e-6 against numpy in float64)."""
    rng = np.random.default_rng(2)
    raw = rng.random((20, 5, 3)) + 1e-3
    gl = torch.as_tensor(np.log(raw / raw.sum(-1, keepdims=True)))
    g0, g2 = mk.gl_rows(gl)
    assert g0.dtype == torch.float32 and g0.is_contiguous()
    assert g0.shape == g2.shape == (20, 5)
    np.testing.assert_allclose(g0.numpy(), np.exp(gl[..., 0].numpy()),
                               rtol=1e-6)
    np.testing.assert_allclose(g2.numpy(), np.exp(gl[..., 2].numpy()),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_macro_slab_matches_pallas_run_macro_slab(dtype):
    """macro_slab (here the plain version of csrc/maf_macro.cu on the
    [bs * nb, N] slab view) against the JAX kernel
    maf_pallas._run_macro_slab in interpret mode, on gl slabs of `dtype`
    holding the same values and the same posterior, S = 300, N = 40
    (schedule (16, (8, 16, 32, 29))): atol 2e-5. Both layouts have pad
    sites: the JAX kernel writes the sentinel 2.0 there, the port cuts
    them, as est_maf_slab does."""
    S, N = 300, 40
    gl, p = _case(300, S, N)
    K0, M = t_maf.macro_schedule(N)
    Ms = tuple(t_maf.macro_rounds(K0, M))
    jp = j_hp.prepare_gl_inputs(jnp.asarray(gl), jnp.zeros(S),
                                gl_dtype=getattr(jnp, dtype))
    out = np.asarray(j_mp._run_macro_slab(
        jp["g0"], jp["g2"], j_hp.pack_sites2(jnp.asarray(p), jp), jp["C"],
        jp["nb_p"], jp["G"], jp["bs"], jp["nb"], S, N, jp["bs_pad"], K0,
        Ms))[:, 0, :]
    sites = np.swapaxes(out, 0, 1)[:jp["nb"], :jp["bs"]].reshape(-1)
    assert np.all(sites[S:] == 2.0) and np.all(out[jp["bs"]:] == 2.0)
    tp = hk.prepare_gl_inputs(torch.as_tensor(gl), torch.zeros(S),
                              gl_dtype=getattr(torch, dtype))
    assert tp["nb"] * tp["bs"] > S  # the port's layout pads too
    got = mk.macro_slab(tp, hk.pack_sites2(torch.as_tensor(p), tp))
    assert got.shape == (S,) and got.dtype == torch.float32
    observed(f"macro_slab vs _run_macro_slab ({dtype})", got, sites[:S])
    np.testing.assert_allclose(got.numpy(), sites[:S], atol=2e-5)


def test_macro_slab_equals_est_maf_slab():
    """On the CPU macro_slab and est_maf_slab run the same arithmetic on
    the same slabs (one schedule in one function, or kernel A, windows and
    kernel B): equal freqs, float32 and bfloat16 (S = 500, N = 33). Each
    counts its plain version under its own name, and without a schedule
    (N < 32) macro_slab raises."""
    S, N = 500, 33
    gl, p = _case(33, S, N)
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        tp = hk.prepare_gl_inputs(torch.as_tensor(gl), torch.zeros(S),
                                  gl_dtype=dtype)
        slab = hk.pack_sites2(torch.as_tensor(p), tp)
        calls = dict(PLAIN_CALLS)
        got = mk.macro_slab(tp, slab)
        assert PLAIN_CALLS["maf_macro_slab" + sfx] == calls.get(
            "maf_macro_slab" + sfx, 0) + 1
        assert PLAIN_CALLS["maf_macro"] == calls.get("maf_macro", 0)
        assert torch.equal(got, mk.est_maf_slab(tp, slab))
    small = hk.prepare_gl_inputs(torch.as_tensor(gl[:, :8]), torch.zeros(S))
    with pytest.raises(ValueError, match="macro schedule"):
        mk.macro_slab(small, hk.pack_sites2(torch.as_tensor(p[:, :8]),
                                            small))
