"""est_maf of the port (ngsf_hmm_tpu_torch.ops.maf, plain torch) against
ngsf_hmm_tpu.ops.maf on the CPU, float64, from numpy seeds. The kernels of
the freq M-step are held in tests/test_torch_maf_kernels.py (kernel A's
lane geometry here: no tensors) and the macro schedules in
tests/test_torch_ops.py. The files are kept small: the test
runner hands out whole files, those with the most tests first, and the
port's quick files should not stand in the queue before the JAX package's
long ones.

Tolerances, with their reasons:
- est_maf float64: rtol 1e-10 (same formulas, other summation order).
- macro against the exact iterate: 1e-4 (the drift gate of test_maf.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ngsf_hmm_tpu.ops import maf as j_maf
from ngsf_hmm_tpu_torch.ops import maf as t_maf
from ngsf_hmm_tpu_torch.ops import maf_kernels as mk

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)


def realistic_gls(rng, S, N, depth_mean=2.0, err=0.01):
    """Poisson-depth binomial-error genotype likelihoods, LINEAR space,
    normalised (the model of tests/test_maf.py)."""
    depth = rng.poisson(depth_mean, size=(S, N))
    tf = rng.uniform(0.05, 0.45, size=S)
    g = (rng.random((S, N)) < tf[:, None]).astype(int) + (
        rng.random((S, N)) < tf[:, None]).astype(int)
    pg = np.array([err, 0.5, 1 - err])
    der = rng.binomial(depth, pg[g])
    k, n = der[..., None].astype(float), depth[..., None].astype(float)
    ll = k * np.log(pg) + (n - k) * np.log1p(-pg)
    gl = np.exp(ll - ll.max(-1, keepdims=True))
    return gl / gl.sum(-1, keepdims=True)


def scaled_diff(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def observed(what, got, want):
    """Print the largest difference (shown by `pytest -rP`): the record of
    what each comparison came to."""
    d = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    print(f"observed {what}: max abs diff {d:.3g}")


# ---------------------------------------------------------------------------
# ops/maf.py, float64
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f64_case():
    rng = np.random.default_rng(31)
    S, N = 60, 40
    gl = realistic_gls(rng, S, N)
    F = rng.random((S, N)) * 0.9
    F[3] = 1.0  # the het floor
    F[4] = 0.0
    return gl, F


@pytest.mark.parametrize("kw", [
    dict(), dict(linear=True), dict(ignore_miss_data=True),
    dict(linear=True, ignore_miss_data=True), dict(linear=True, macro=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "log")
def test_est_maf_matches_jax_f64(f64_case, kw):
    """est_maf in float64 against ngsf_hmm_tpu.ops.maf.est_maf: exact in
    log and linear space, ignore_miss_data, and the macro tier (N = 40:
    the (16, (8, 16, 32, 29)) schedule). rtol 1e-10."""
    gl, F = f64_case
    x = gl if kw.get("linear") else np.log(gl)
    want = np.asarray(j_maf.est_maf(jnp.asarray(x), jnp.asarray(F), **kw))
    got = t_maf.est_maf(torch.as_tensor(x), torch.as_tensor(F), **kw)
    assert got.dtype == torch.float64 and got.shape == (gl.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_est_maf_uniform_prior_and_leading_shape(f64_case):
    """indF=None (the uniform prior, gen_func.cpp:987-989) against the JAX
    function, rtol 1e-10, also with a blocked [2, 30] leading site shape."""
    gl, _ = f64_case
    lg = np.log(gl)
    want = np.asarray(j_maf.est_maf(jnp.asarray(lg), None))
    got = t_maf.est_maf(torch.as_tensor(lg), None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)
    blocked = t_maf.est_maf(torch.as_tensor(lg.reshape(2, 30, 40, 3)), None)
    np.testing.assert_allclose(blocked.numpy().reshape(-1), want, rtol=1e-10)



@pytest.mark.parametrize("N", [32, 100])
def test_macro_tracks_own_exact_iterate(N):
    """The macro tier against the port's own exact damped iterate, at both
    schedules, including a het-floor row: the 1e-4 drift gate of
    tests/test_maf.py. Below 32 individuals macro=True is the exact loop."""
    rng = np.random.default_rng(77 + N)
    S = 400
    gl = torch.as_tensor(realistic_gls(rng, S, N))
    F = rng.random((S, N)) * 0.9
    F[0] = 1.0
    F = torch.as_tensor(F)
    exact = t_maf.est_maf(gl, F, linear=True)
    fast = t_maf.est_maf(gl, F, linear=True, macro=True)
    assert float((exact - fast).abs().max()) <= 1e-4
    small = t_maf.est_maf(gl[:, :8], F[:, :8], linear=True, macro=True)
    assert torch.equal(small, t_maf.est_maf(gl[:, :8], F[:, :8], linear=True))


def test_est_maf_refuses_what_is_not_ported(f64_case):
    gl, F = f64_case
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_maf.est_maf(torch.as_tensor(gl), torch.as_tensor(F), linear=True,
                      axis_name="ind")
    with pytest.raises(ValueError, match="linear=True"):
        t_maf.est_maf(torch.as_tensor(np.log(gl)), torch.as_tensor(F),
                      macro=True)


def test_state_grad_geometry():
    """Kernel A's lanes a site G and cells a lane C (ops/maf_kernels.py
    state_grad_geometry, passed to the launch) at N = 1, 31, 32, 33, 100,
    128, 129 and 1000: the fewest lane slots with at most
    STATE_GRAD_MAX_CELLS cells a lane, the smaller G on a tie, and C = 0
    (planes recomputed) past 32 such cells; every pair it picks is one
    csrc/maf_state_grad.cu's dispatch list instantiates."""
    import pathlib
    import re

    src = (pathlib.Path(mk.__file__).parents[1] / "csrc" /
           "maf_state_grad.cu").read_text()
    pairs = {(int(g), int(c)) for g, c in re.findall(r"GC\((\d+), (\d+)\)",
                                                     src)}
    for N, want in [(1, (8, 1)), (31, (8, 4)), (32, (8, 4)), (33, (8, 5)),
                     (100, (16, 7)), (128, (16, 8)), (129, (32, 5)),
                     (1000, (32, 0))]:
        G, C = mk.state_grad_geometry(N)
        assert (G, C) == want, N
        assert G in (8, 16, 32) and 32 % G == 0
        if C:
            assert G * C >= N and C <= mk.STATE_GRAD_MAX_CELLS
            assert G == 8 or G * C < N + G  # no smaller G fits as few slots
        else:
            assert N > 32 * mk.STATE_GRAD_MAX_CELLS
        assert (G, C) in pairs, N
