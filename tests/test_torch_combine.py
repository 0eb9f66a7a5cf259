"""The port's two-level cross-block combine
(ngsf_hmm_tpu_torch.models.hmm_kernels._combine_blocks, on the CPU through
the kernel's plain version) against the JAX package's
ngsf_hmm_tpu.models.hmm_pallas._combine_blocks (two XLA associative scans,
no Pallas).

Inputs: random positive per-block products A_r [nb, 5, B, N] made with
numpy from a seed (entries spread over a few powers of two, log-offsets
like those of blocks of a few hundred sites), some blocks with equal rows
(a chromosome break at the block's first site), F down to the lower clamp
F_MIN on some individuals.

Gates and why: both sides compose the same rescaled float32 products in
another order (chunks of L blocks here, a log-depth scan there), so the
vectors agree to float32 rounding: starts / ends normalised per vector
within atol 1e-5; the log-likelihoods (offsets summed in float64 here, in
float32 there) within rtol 2e-6, the gate of
test_torch_hmm_kernels.py::test_posteriors_fused_matches_jax; ll_f and
ll_b of the port within 1e-3 absolute of each other (chip_smoke.py's
gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngsf_hmm_tpu.models import hmm_pallas as hp
from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
from ngsf_hmm_tpu_torch.utils import cuda_lib
from ngsf_hmm_tpu_torch.utils.constants import F_MIN

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

N = 5
V_ATOL = 1e-5
LL_RTOL = 2e-6
FWBW_ATOL = 1e-3

_j_combine = jax.jit(hp._combine_blocks)


def _inputs(nb, B, seed):
    """(A_r [nb, 5, B, N] float32, F [B, N] float32) from a seed."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, (nb, 4, B, N)) * np.exp2(
        rng.integers(-6, 7, (nb, 1, B, N)))
    brk = rng.random(nb) < 0.1  # a chromosome break: both rows equal
    A[brk, 2] = A[brk, 0]
    A[brk, 3] = A[brk, 1]
    off = rng.uniform(-400.0, -50.0, (nb, 1, B, N))
    A_r = np.concatenate([A, off], axis=1).astype(np.float32)
    F = rng.uniform(0.01, 0.6, (B, N))
    F[:, 0] = F_MIN
    F[:, 1] = 10 * F_MIN
    return A_r, F.astype(np.float32)


def _norm(v):
    v = np.asarray(v, np.float64)
    return v / v.sum(1, keepdims=True)


@pytest.mark.parametrize("nb,B,L", [
    (1, 1, None), (7, 1, 1), (7, 2, 10), (15, 2, 16), (17, 1, 16),
    (2703, 1, None), (2703, 2, 1)],
    ids=lambda v: "default" if v is None else str(v))
def test_combine_matches_jax(nb, B, L):
    A_r, F = _inputs(nb, B, seed=nb + 100 * B)
    st, en, ll = hk._combine_blocks(torch.from_numpy(A_r),
                                    torch.from_numpy(F), L=L)
    assert st.shape == en.shape == (nb, 2, B, N)
    assert ll.shape == (2, B, N) and ll.dtype == torch.float64
    js, je, jl = _j_combine(jnp.asarray(A_r), jnp.asarray(F))
    np.testing.assert_allclose(_norm(st.numpy()), _norm(js), atol=V_ATOL)
    np.testing.assert_allclose(_norm(en.numpy()), _norm(je), atol=V_ATOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jl, np.float64),
                               rtol=LL_RTOL)
    assert float((ll[0] - ll[1]).abs().max()) < FWBW_ATOL
    # the chain's boundary vectors pass through unscaled
    assert torch.equal(st[0, 1], torch.from_numpy(F))
    assert bool((en[-1] == 1.0).all())


@pytest.mark.parametrize("L", [None, 3])
def test_combine_candidate_independent_of_B(L):
    """Candidate 0 of B = 2 gives candidate 0's result at B = 1, bit for
    bit: every (candidate, individual) runs on its own."""
    A_r, F = _inputs(40, 2, seed=7)
    A2, F2 = torch.from_numpy(A_r), torch.from_numpy(F)
    two = hk._combine_blocks(A2, F2, L=L)
    one = hk._combine_blocks(A2[:, :, :1], F2[:1], L=L)
    for a, b in zip(two, one):
        assert torch.equal(a[..., :1, :], b)


def test_combine_chunk_len_and_refusals():
    assert hk.combine_chunk_len(1) == 1
    assert hk.combine_chunk_len(2703) == 52  # the main path's nb
    assert hk.combine_chunk_len(136) == 12  # the restart path's nb
    for nb in (2, 100, 129, 10**6):
        L = hk.combine_chunk_len(nb)
        assert -(-nb // L) <= cuda_lib.COMBINE_MAX_CHUNKS and L * L >= nb
    A_r, F = _inputs(7, 1, seed=3)
    A_t, F_t = torch.from_numpy(A_r), torch.from_numpy(F)
    with pytest.raises(ValueError, match="chunk length"):
        hk._combine_blocks(A_t, F_t, L=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hk._combine_blocks(A_t, F_t, v0=torch.ones(1, N, 2))
