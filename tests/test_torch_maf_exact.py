"""The lane geometry of the segment est_maf kernels and the plain version of
maf_exact in its Horner form, on the CPU.

maf_exact (csrc/maf_exact.cu) gives a site G lanes of 1 to 32 with C cells
each (ops/maf_kernels.py exact_geometry); kernel A and maf_macro keep G of
8, 16 or 32 (state_grad_geometry); kernel B (csrc/maf_sums_grad.cu) takes
G of 8, 16 or 32 and stages tiles of 256 / G sites in shared memory where
they fit (sums_grad_geometry). No tensors for the geometry: the choices,
the CUDA sources' constants and dispatch lists are read as they are. The plain
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


def _source(name):
    return (pathlib.Path(mk.__file__).parents[1] / "csrc" / name).read_text()


def _dispatch_pairs(source):
    """The (G, C) pairs a csrc source's GC(...) dispatch list
    instantiates."""
    return {(int(g), int(c))
            for g, c in re.findall(r"GC\((\d+), (\d+)\)", _source(source))}


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


def test_sums_grad_geometry():
    """Kernel B's (G, staged) for N individuals on float32 (4-byte) and
    bfloat16 (2-byte) gl: among G of 8, 16, 32 whose ring of three tiles
    leaves room for three CTAs an SM, the fewest lane slots G * ceil(N /
    G), the smaller G on a tie; else G = 32, staged while its ring fits
    one CTA. At N = 100 G = 16 on both widths (kernel A's G there), at 130
    G = 16 (kernel A's 32: no C <= 8 at 16 lanes), staged up to 806
    individuals on float32 gl and 1,210 on bfloat16."""
    share = mk.SM_SMEM // 3 - mk.CTA_SMEM_RESERVED
    for gl_bytes in (4, 2):
        for N in range(1, 1400):
            G, staged = mk.sums_grad_geometry(N, gl_bytes)
            ring = {g: mk.sums_grad_ring_bytes(g, N, gl_bytes)
                    for g in (8, 16, 32)}
            fits = [g for g in ring if ring[g] <= share]
            if fits:
                least = min(g * -(-N // g) for g in fits)
                assert staged and G == min(
                    g for g in fits if g * -(-N // g) == least), N
            else:
                assert G == 32 and staged == (ring[32] <= mk.CTA_SMEM), N
    want = {(32, 4): (8, True), (100, 4): (16, True), (100, 2): (16, True),
            (130, 4): (16, True), (300, 4): (32, True), (806, 4): (32, True),
            (807, 4): (32, False), (1210, 2): (32, True),
            (1211, 2): (32, False), (1300, 4): (32, False)}
    assert {k: mk.sums_grad_geometry(*k) for k in want} == want
    assert mk.sums_grad_geometry(100, 4)[0] == mk.state_grad_geometry(100)[0]
    # a tile's bytes: 8 sites x 100 cells x (2 x 4 + 4) + 8 freqs
    assert mk.sums_grad_ring_bytes(32, 100, 4) == 3 * 9632


def test_sums_grad_geometry_refusals_and_source():
    """sums_grad_geometry refuses N < 1 and gl cells of other than 2 or 4
    bytes; its constants are csrc/maf_sums_grad.cu's, whose launch takes
    every G it picks (and refuses others)."""
    for bad in ((0, 4), (-3, 2), (100, 8), (100, 1)):
        with pytest.raises(ValueError):
            mk.sums_grad_geometry(*bad)
    src = _source("maf_sums_grad.cu")
    consts = dict(re.findall(r"#define (NGSF_SG_\w+) (\d+)", src))
    assert int(consts["NGSF_SG_THREADS"]) == mk.SUMS_GRAD_THREADS
    assert int(consts["NGSF_SG_STAGES"]) == mk.SUMS_GRAD_STAGES
    assert int(consts["NGSF_SG_SMEM"]) == mk.CTA_SMEM
    launched = {int(g) for g in re.findall(r"if \(G == (\d+)\) return", src)}
    picked = {mk.sums_grad_geometry(N, b)[0] for N in range(1, 1400)
              for b in (2, 4)}
    assert picked == launched == {8, 16, 32}


def test_sums_grad_plain_is_kernel_a_gradient_at_its_freq():
    """Kernel B's plain version at kernel A's final freq gives kernel A's
    gradient rows bit for bit (the same cells and sums at the same freq;
    on the card the two kernels share their cells and, at the same lanes a
    site, their order, and chip_smoke.py holds them equal), on float32 and
    bfloat16 slabs."""
    rng = np.random.default_rng(77)
    S, N = 300, 40
    gl = torch.as_tensor(realistic_gls(rng, S, N).astype(np.float32))
    p = torch.as_tensor(rng.random((S, N)).astype(np.float32))
    p[3, :7] = 1.0  # the het floor
    for dt in (torch.float32, torch.bfloat16):
        tp = hk.prepare_gl_inputs(gl, torch.zeros(S), gl_dtype=dt)
        slab = hk.pack_sites2(p, tp, 0.5)
        a = mk._k_maf_state_grad(tp["g0"], tp["g2"], slab, 8)
        b = mk._k_maf_sums_grad(tp["g0"], tp["g2"], slab,
                                a[0].contiguous())
        assert torch.equal(b, a[4:]), dt


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
