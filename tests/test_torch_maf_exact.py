"""The lane geometry of the segment est_maf kernels and the plain version of
maf_exact in its Horner form, on the CPU.

maf_exact (csrc/maf_exact.cu) gives a site G lanes of 1 to 32 with C cells
each (ops/maf_kernels.py exact_geometry); kernel A and maf_macro keep G of
8, 16 or 32 (state_grad_geometry). No tensors for the geometry: the
choices and the CUDA dispatch lists are read as they are. The plain
version _exact_plain (Horner planes, _sums_plain, _advance_plain) is held
against the JAX package's exact est_maf (XLA, linear space) at one N for
each G that exact_geometry chooses below 64 individuals; the Pallas
kernel _run in interpret mode is held in tests/test_torch_maf_kernels.py
and tests/test_torch_maf_macro.py.

Tolerances, with their reasons:
- freq atol 2e-5: the JAX package's pallas-vs-XLA gate (tests/test_maf.py);
  the two sides evaluate the same fixed point in another float32 form
  (Horner planes against the direct genotype posteriors).
"""

import pathlib
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ngsf_hmm_tpu.ops import maf as j_maf
from ngsf_hmm_tpu.ops.hwe import check_interv as j_check_interv
from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
from ngsf_hmm_tpu_torch.utils.constants import EPSILON
from test_torch_maf import observed, realistic_gls

# the suite runs several workers side by side: keep torch to one thread
torch.set_num_threads(1)

LANES = (1, 2, 4, 8, 16, 32)


def _dispatch_pairs(source):
    """The (G, C) pairs a csrc source's GC(...) dispatch list
    instantiates."""
    src = (pathlib.Path(mk.__file__).parents[1] / "csrc" / source
           ).read_text()
    return {(int(g), int(c))
            for g, c in re.findall(r"GC\((\d+), (\d+)\)", src)}


def test_exact_geometry_fewest_slots():
    """For N = 1..64: the fewest lane slots G * C >= N with C <=
    STATE_GRAD_MAX_CELLS over G in 1, 2, 4, 8, 16, 32, the smaller G on a
    tie (checked against every G); N = 20 gives G = 4, C = 5."""
    cap = mk.STATE_GRAD_MAX_CELLS
    for N in range(1, 65):
        G, C = mk.exact_geometry(N)
        fits = [(g, -(-N // g)) for g in LANES if -(-N // g) <= cap]
        least = min(g * c for g, c in fits)
        assert G * C == least, N
        assert G == min(g for g, c in fits if g * c == least), N
        assert G * C >= N and 1 <= C <= cap
    assert mk.exact_geometry(20) == (4, 5)
    assert mk.exact_geometry(31) == (4, 8)
    assert mk.exact_geometry(12) == (2, 6)
    assert mk.exact_geometry(3) == (1, 3)
    assert mk.exact_geometry(100) == (16, 7)
    assert mk.exact_geometry(1000) == (32, 0)


def test_exact_geometry_is_instantiated():
    """Every pair exact_geometry picks for N = 1..300 is one that
    csrc/maf_exact.cu's dispatch list instantiates, and every G it can
    pick occurs."""
    pairs = _dispatch_pairs("maf_exact.cu")
    picked = {mk.exact_geometry(N) for N in range(1, 301)}
    assert picked <= pairs
    assert {g for g, _ in picked} == set(LANES)


def test_state_grad_geometry_unchanged():
    """Kernel A's and maf_macro's (G, C) at N = 32, 40, 100, 130 and 300
    are what they were before exact_geometry came beside them (at N = 32
    (8, 4), not the tied (4, 8) that a G of 4 would give); maf_macro.cu
    instantiates the same pairs as maf_state_grad.cu."""
    want = {32: (8, 4), 40: (8, 5), 100: (16, 7), 130: (32, 5),
            300: (32, 0)}
    assert {N: mk.state_grad_geometry(N) for N in want} == want
    assert _dispatch_pairs("maf_macro.cu") == _dispatch_pairs(
        "maf_state_grad.cu")


@pytest.mark.parametrize("N", [1, 3, 12, 20, 31, 40])
def test_exact_plain_matches_jax_est_maf(N):
    """est_maf_exact on the CPU (the Horner-form _exact_plain, snap=True
    on the raw posterior slab) against JAX est_maf(linear=True) on the
    snapped posterior, at N of each G exact_geometry chooses up to 40
    individuals (1, 1, 2, 4, 4, 8 lanes a site): atol 2e-5. The posterior
    holds values within EPSILON of 0 and 1 and exact ones, so the snap
    and the het floor engage."""
    rng = np.random.default_rng(400 + N)
    S = 257
    gl = realistic_gls(rng, S, N).astype(np.float32)
    p = rng.random((S, N)).astype(np.float32)
    p[5] = 1.0 - EPSILON / 3  # snapped to 1: the het floor
    p[6] = EPSILON / 4  # snapped to 0
    p[7, : (N + 1) // 2] = 1.0
    gl[7, 0] = [0.0, 1.0, 0.0]  # het-certain at full IBD
    tp = hk.prepare_gl_inputs(torch.as_tensor(gl), torch.zeros(S))
    got = mk.est_maf_exact(tp, hk.pack_sites2(torch.as_tensor(p), tp, 0.5))
    assert got.shape == (S,) and bool(torch.isfinite(got).all())
    want = np.asarray(j_maf.est_maf(jnp.asarray(gl),
                                    j_check_interv(jnp.asarray(p)),
                                    linear=True))
    observed(f"est_maf_exact (Horner plain, N = {N}) vs JAX est_maf", got,
             want)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
