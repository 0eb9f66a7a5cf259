#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ngsf_hmm_tpu_torch) on one GPU.

    python3 chip_smoke.py

needs one CUDA device and nvcc. It
  1. requires the card and prints its name and power limit,
  2. builds the CUDA kernels from ngsf_hmm_tpu_torch/csrc (set-up time),
     then compiles the transfer kernels, kernel A, maf_exact and maf_macro
     alone to print their registers, spills, residency, waves and SASS
     loops, and for the last two the SASS of a pass, a gradient round and
     a window step and their issue floor (probe_build),
  3. holds every kernel against its plain PyTorch version on the card, at a
     shape with a ragged last block and chromosome breaks and at the main
     path's shape, and times both there; the est_maf kernels read the
     posterior slab the chain kernels produced there, and the exact one is
     also held at 20 individuals; at the main shape the est_maf kernels
     are also timed in a second build with FMA contraction on; the
     emission-slab ("_v1") instantiations of the four stream kernels are
     held at the ragged shape and at the restart path's shape; the row
     est_maf kernel (maf_macro) and the slab est_maf kernels at 33,333
     sites x 40, 32, 130 and 300 individuals (every lane geometry of
     kernel A) and maf_macro at the LD path's shape, and maf_exact on the
     row view at 20 individuals and at 33,333 sites x 1, 7, 12, 31, 40,
     100, 200 and 300 individuals (every lane geometry it can choose) on a
     posterior with cells within EPSILON of 0 and 1; est_maf_exact,
     macro_slab and est_maf_rows against ops/maf.est_maf run in float64
     at the exact, main and LD shapes (f64_anchor); the stream kernels
     of all three sources at 3,001 sites x 33 and 34 columns (every copy
     width of the transfer-and-tangent kernel, also on slabs that start
     one element into their storage); wherever the transfer-and-tangent
     kernel is held, also against the product rule carried in float64;
     at the main and restart shapes that kernel split into its step from
     registers and its loads alone (probe_transfer); at the LD path's
     shape maf_macro split into its real passes, its gradient rounds and
     its windows; the bfloat16 gl exports
     ("_bf16") of the stream and slab est_maf kernels at the main path's
     shape, on bfloat16 slabs of the same gl; the one-launch slab est_maf
     (maf_macro_slab, float32 and bfloat16 slabs) at the main path's shape and at the maf_macro
     shapes, also against est_maf_slab; the combine bit-equal to its plain
     version (candidate 0 of B = 2 equal to B = 1), timed at every shape
     the streams are checked at (the restart path's nb = 136 among them);
     Viterbi with zero path mismatches (both variants; the compat one
     only at the main shape, where the plain loop takes minutes), its log
     line beside the forward chain's derived floor and that chain's own
     measured time, and at 20,011 x 100 and 2,003 x 263 to 3,001 (every
     group of individuals a forward CTA holds) with chromosome breaks,
     forced (init_logits, final_state) and traceback blocks of 256, 1 and
     77 sites,
  4. drives seven paths, each with the launch counts set to 0 just before
     and read just after: init_state -> run_em (min_iters 3, max_iters 4,
     Viterbi) [-> the three writers]
       main     1,000,000 sites x 100 individuals, float32, freq_est 1 (the
                default: E-step, (F, alpha) M-step, freq M-step on the
                macro-stepped est_maf kernels), with the writers; at its
                end est_maf_slab and macro_slab on one posterior slab at
                the final parameters,
       bf16     the main path's data and options with bfloat16 gl slabs
                (EMOptions(gl_bf16=True), the bfloat16 exports only), no
                writers, the same est_maf_slab / macro_slab step at its
                end; its final state held against main's at the JAX
                package's bf16 envelopes,
       fixed    200,003 x 100, freq_est 0 (frequencies held fixed), with
                the writers,
       exact    200,003 x 20, freq_est 1 on the exact est_maf kernel (fewer
                than 32 individuals have no macro schedule),
       restart  200,003 x 100 with 20 replicates (the ngsF-HMM.sh protocol:
                stack_restart_states -> run_em_restarts, replicates
                flattened into 2,000 columns on the emission-slab kernels,
                freq_est 1, best-replicate Viterbi, no writers),
       ld       the main path's data with --e_prob 2 --freq_est 1 (the LD
                path: haplotype EM at init, LD emissions, the emission-slab
                kernels and maf_macro every iteration), no writers,
       ld2      the first 200,003 sites of that data with --freq_est 2
                --e_prob 2 (the haplotype EM every iteration), no writers,
  5. runs the CLI four times at a small size (--freq e, freq_est 1; once
     more with --n_rep 3; once with --freq_est 2 --e_prob 2; once with
     --gl_bf16 1).
--against LOG also holds main's streams per iteration, final tot_lkl
and Viterbi IBD share to another tree's log of the same run (the parent's,
in one call). --probes runs only the measurements and exits 4;
--probe-build CSRC runs only probe_build on another tree's sources.
--maf-anchor OUT [--tree DIR] runs only the float64 anchor and the exact
and ld paths (of DIR's package), writes their readings and final freqs
under OUT and exits 4; --against-maf OUT then sets this run's anchor
beside them and holds the exact and ld paths' final freqs to them.

Any failure exits non-zero. The last line printed is
{"ok": true, "device": {...}}; the line before it lists every kernel with
its launches summed over the paths and per path, its error against the
plain version and its times.

--rehearse runs the same control flow at a tiny size on the CPU through the
plain versions (to find wrong shapes and paths without a card); it never
prints the ok line and exits 3.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# Viterbi's forward chain floor, derived, not measured: dependent float32
# operations a site (add, max, add, add, max, add under the in-place
# update; add, max, add textbook) at an assumed 4 cycles each, over the
# card's highest SM clock (nvidia-smi clocks.max.sm, read in main). The
# log prints it beside the measured time of that chain alone (probe_chain).
CHAIN_CYCLES = {True: 24, False: 12}
SM_CLOCK_MHZ = 1980.0


def chain_floor_ms(S, compat):
    return S * CHAIN_CYCLES[compat] / (SM_CLOCK_MHZ * 1e6) * 1e3


# Viterbi's forward chain alone, from registers: the forward kernel's own
# site step (vt_site of csrc/viterbi.cu) S times, its back-pointer bits
# packed 16 sites a word, one chain lane per individual (lane 0 of a CTA,
# as in the forward kernel), no loads and no staging. Built and timed by
# probe_chain.
CHAIN_PROBE_CU = r"""
#include "viterbi.cu"
template <bool COMPAT>
__global__ void chain(const float* q, float* out, int S) {
    if (threadIdx.x) return;
    q += 6 * blockIdx.x;
    const Quad<float> lt = {q[0], q[1], q[2], q[3]};
    const Pair<float> em = {q[4], q[5]};
    float v0 = 0.f, v1 = 0.f;
    unsigned acc = 0;
    for (int s = 0; s < S; s += 16) {  // S rounded up to 16 sites
        unsigned w = 0;
#pragma unroll
        for (int u = 0; u < 16; ++u) vt_site<float, COMPAT>(lt, em, u, v0, v1, w);
        acc ^= w;
    }
    out[blockIdx.x] = v0 + v1 + (float)acc;
}
extern "C" int chain_probe(const float* q, float* out, int S, int N,
                           int compat, void* st) {
    if (compat) chain<true><<<N, 32, 0, (cudaStream_t)st>>>(q, out, S);
    else chain<false><<<N, 32, 0, (cudaStream_t)st>>>(q, out, S);
    return (int)cudaGetLastError();
}
"""


# Gates against the plain versions (same arithmetic in the same order; what
# is left is expf/logf against torch.exp/torch.log).
ATOL = 2e-5      # normalised products, ratios, posteriors
LL_RTOL = 2e-6   # log-likelihoods
# The transfer-and-tangent kernel's tangents against the product rule
# carried in float64 (check_tangents_f64), measured as the ATOL gate
# measures them, per site of the block: a float32 chain's distance from
# float64 grows with its length. Set from the readings on the card
# (PERF.md section 6): the separate-product float32 chain the kernel
# replaced reads 2.2e-8 to 5.1e-8 a site (bs 33 to 1,471), the kernel
# 1.8e-8 to 4.5e-8.
TANGENT_F64_ATOL_SITE = 6e-8
# est_maf kernels: the sum over individuals runs in another order than
# torch.sum, so values agree to float32 rounding (relative to max(|x|, 1))
# except at sites where that rounding flips the |prev - freq| > EPSILON
# test: such a site stops one pass earlier or later, which moves its freq
# by one damped step (< MAF_FREQ_ATOL) and its sums by one increment.
MAF_RTOL = 2e-5
MAF_FREQ_ATOL = 2e-5
MAF_FLIP_SHARE = 1e-3  # most sites that may stop at another pass
# bfloat16 gl slabs against float32 ones, whole runs: the JAX package's
# input-noise envelopes (tests/test_bf16.py:87, :111-114)
BF16_FREQ_ATOL = 3e-3
BF16_LL_RTOL = 5e-4

# Float operations per (site, lane), counted from the CUDA sources
# (emission prologue 25 on the gl slabs, none on the emission slabs;
# transition 12; then the product / rescale step). The transfer-and-tangent
# step (csrc/block_transfer_grad.cu, GradLane) counts each fused
# multiply-add as two operations, the way the 67 TFLOP/s peak does: the
# per-lane emissions 14 (the prior coefficients are per (site, block)),
# the decay 3, the transition matrix 8, the primal product, maximum and
# rescale 20, the tangents 57 (M scaled by the lagging scale 4, the
# factors 13, the 16 fused updates 32, their 8 products 8).
FLOPS_CELL = {
    "block_transfer_grad": 14 + 3 + 8 + 20 + 57,
    "block_transfer": 37 + 21,
    "bw_sites": 37 + 14,
    "fw_post": 37 + 18,
    "block_transfer_grad_v1": 3 + 8 + 20 + 57,
    "block_transfer_v1": 12 + 21,
    "bw_sites_v1": 12 + 14,
    "fw_post_v1": 12 + 18,
    # est_maf (csrc/maf_common.cuh): the planes of a cell, one pass over
    # it and one gradient evaluation (maf_cell), and one step of the
    # per-site window (maf_advance); the same in the fused form of the
    # segment kernels maf_exact and maf_macro (maf_cell_fma, with f (1 -
    # f) once a lane and pass; the window steps of an active site,
    # maf_advance_active)
    "maf_planes": 24,
    "maf_pass": 16,
    "maf_grad": 31,
    "maf_window_step": 16,
    "maf_pass_fma": 15,
    "maf_grad_fma": 30,
    "maf_window_step_active": 12,
}
# maf_exact's operations: the planes of a cell, then per site the passes
# its data needs (maf_pass_fma per cell); maf_macro's: the planes of a
# cell, then per site the real passes, gradient evaluations and window
# steps its data needs (maf_pass_fma, maf_grad_fma per cell;
# maf_window_step_active per site).

KERNELS = {
    # name: (source, TPU kernel replaced)
    "block_transfer_grad": (
        "ngsf_hmm_tpu_torch/csrc/block_transfer_grad.cu",
        "ngsf_hmm_tpu/models/hmm_pallas.py:1211"),
    "bw_sites": ("ngsf_hmm_tpu_torch/csrc/bw_sites.cu",
                 "ngsf_hmm_tpu/models/hmm_pallas.py:1288"),
    "fw_post": ("ngsf_hmm_tpu_torch/csrc/fw_post.cu",
                "ngsf_hmm_tpu/models/hmm_pallas.py:1345"),
    "block_transfer": ("ngsf_hmm_tpu_torch/csrc/block_transfer.cu",
                       "ngsf_hmm_tpu/models/hmm_pallas.py:1157"),
    "combine_blocks": (
        "ngsf_hmm_tpu_torch/csrc/combine_blocks.cu",
        "ngsf_hmm_tpu/models/hmm_pallas.py:461 (XLA scans, no TPU kernel)"),
    "viterbi": (
        "ngsf_hmm_tpu_torch/csrc/viterbi.cu",
        "ngsf_hmm_tpu/models/hmm.py:206 (lax.scan, no TPU kernel)"),
    "maf_state_grad": ("ngsf_hmm_tpu_torch/csrc/maf_state_grad.cu",
                       "ngsf_hmm_tpu/ops/maf_pallas.py:662"),
    "maf_sums_grad": ("ngsf_hmm_tpu_torch/csrc/maf_sums_grad.cu",
                      "ngsf_hmm_tpu/ops/maf_pallas.py:744"),
    "maf_window": (
        "ngsf_hmm_tpu_torch/csrc/maf_window.cu",
        "ngsf_hmm_tpu/ops/maf_pallas.py:776 (XLA elementwise, no TPU "
        "kernel)"),
    "maf_exact": ("ngsf_hmm_tpu_torch/csrc/maf_exact.cu",
                  "ngsf_hmm_tpu/ops/maf_pallas.py:85"),
    "maf_macro": ("ngsf_hmm_tpu_torch/csrc/maf_macro.cu",
                  "ngsf_hmm_tpu/ops/maf_pallas.py:167"),
    # maf_macro.cu on the [bs * nb, N] view of the gl slabs
    "maf_macro_slab": ("ngsf_hmm_tpu_torch/csrc/maf_macro.cu",
                       "ngsf_hmm_tpu/ops/maf_pallas.py:395"),
    # the emission-slab instantiations of the four stream templates
    "block_transfer_grad_v1": (
        "ngsf_hmm_tpu_torch/csrc/block_transfer_grad.cu",
        "ngsf_hmm_tpu/models/hmm_pallas.py:590"),
    "bw_sites_v1": ("ngsf_hmm_tpu_torch/csrc/bw_sites.cu",
                    "ngsf_hmm_tpu/models/hmm_pallas.py:530"),
    "fw_post_v1": ("ngsf_hmm_tpu_torch/csrc/fw_post.cu",
                   "ngsf_hmm_tpu/models/hmm_pallas.py:685"),
    "block_transfer_v1": ("ngsf_hmm_tpu_torch/csrc/block_transfer.cu",
                          "ngsf_hmm_tpu/models/hmm_pallas.py:385"),
}
STREAM_KERNELS = ("block_transfer_grad", "block_transfer", "bw_sites",
                  "fw_post")
CHAIN_KERNELS = ("block_transfer_grad", "bw_sites", "fw_post",
                 "block_transfer", "combine_blocks", "viterbi")
SLAB_KERNELS = ("maf_state_grad", "maf_sums_grad", "maf_window")
V1_KERNELS = tuple(k + "_v1" for k in STREAM_KERNELS)
# the kernels that read gl slabs; each has a bfloat16 export ("_bf16")
GL_KERNELS = STREAM_KERNELS + ("maf_state_grad", "maf_sums_grad",
                               "maf_macro_slab")
BF16_KERNELS = tuple(k + "_bf16" for k in GL_KERNELS)
for _k in GL_KERNELS:
    KERNELS[_k + "_bf16"] = KERNELS[_k]


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def simulate(S, N, seed, n_chrom=3):
    """Inputs made with numpy from a seed: per-individual inbreeding tracts
    (a two-state chain that refreshes with probability 1 - exp(-alpha d)),
    genotypes under HWE outside and homozygous inside a tract, noisy
    normalised genotype likelihoods, n_chrom chromosomes.

    Returns (gl [S, N, 3] float32 log, dist [S] float64 Mb with inf at
    chromosome breaks, freq [S], indF0 [N], alpha0 [N])."""
    rng = np.random.default_rng(seed)
    freq = rng.uniform(0.05, 0.45, S)
    dist = rng.random(S) * 0.01  # Mb
    dist[0] = 0.5  # the first site's absolute coordinate
    for c in range(1, n_chrom):
        dist[(c * S) // n_chrom] = np.inf
    F_true = rng.uniform(0.05, 0.4, N).astype(np.float32)
    a_true = rng.uniform(0.5, 3.0, N)
    d_fin = np.where(np.isinf(dist), 1e9, dist)
    refresh = rng.random((S, N), dtype=np.float32) < (
        1.0 - np.exp(-a_true[None, :] * d_fin[:, None])).astype(np.float32)
    refresh[0] = True
    draw = rng.random((S, N), dtype=np.float32) < F_true[None, :]
    last = np.maximum.accumulate(
        np.where(refresh, np.arange(S, dtype=np.int32)[:, None], 0), axis=0)
    ibd = np.take_along_axis(draw, last, axis=0)
    del refresh, draw, last
    f32 = freq.astype(np.float32)[:, None]
    a1 = rng.random((S, N), dtype=np.float32) < f32
    a2 = np.where(ibd, a1, rng.random((S, N), dtype=np.float32) < f32)
    geno = a1.astype(np.int8) + a2.astype(np.int8)
    del a1, a2, ibd
    raw = 0.05 + 0.3 * rng.random((S, N, 3), dtype=np.float32)
    np.put_along_axis(raw, geno[..., None].astype(np.int64),
                      np.take_along_axis(
                          raw, geno[..., None].astype(np.int64), axis=2) + 1.0,
                      axis=2)
    gl = np.log(raw / raw.sum(-1, keepdims=True))
    indF0 = rng.uniform(0.05, 0.5, N)
    alpha0 = rng.uniform(0.01, 0.2, N)
    return gl, dist, freq, indF0, alpha0


class Timer:
    """Device time of a callable: CUDA events around `reps` calls after one
    warm-up (host clock on the CPU rehearsal). The calls queue behind a
    QUEUE_MS device sleep, so that a kernel shorter than its wrapper's
    host time is timed back to back, not with the host's gaps."""

    QUEUE_MS = 5.0

    def __init__(self, torch, dev):
        self.torch, self.cuda = torch, dev.type == "cuda"

    def __call__(self, fn, reps=3, warm=1):
        torch = self.torch
        for _ in range(warm):
            out = fn()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            return out, (time.perf_counter() - t0) * 1e3 / reps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(self.QUEUE_MS * 1e3 * SM_CLOCK_MHZ))
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps


class Recorder:
    """Collects each kernel's error, times and bound at one shape."""

    def __init__(self, torch, label, results):
        self.torch, self.label, self.results = torch, label, results

    def record(self, name, err, ms, plain_ms, nbytes, flops):
        b_ms, f_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
        if not np.isfinite(err):
            fail(f"{name} [{self.label}]: non-finite difference")
        r = self.results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r.update(ms=ms, plain_ms=plain_ms, bytes=int(nbytes),
                 bound_ms=max(b_ms, f_ms),
                 bound_by="bytes" if b_ms >= f_ms else "operations")
        log(f"[{self.label}] {name}: max diff {err:.3g}, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms, bytes {nbytes / 1e6:.1f} MB, "
            f"bound {max(b_ms, f_ms):.4f} ms ({r['bound_by']})")

    def finite(self, name, *ts):
        for t in ts:
            if not bool(self.torch.isfinite(t).all()):
                fail(f"{name} [{self.label}]: NaN or inf in the output")


def maf_compare(torch, rec, name, got, want, rows):
    """An est_maf kernel's per-site rows against the plain version's (see
    MAF_RTOL above). Returns the largest scaled difference over the sites
    that stopped at the same pass; fails on any gate."""
    rec.finite(name, got, want)
    rel = (got - want).abs() / want.abs().clamp_min(1.0)
    off = (rel > MAF_RTOL).any(0)
    if "active" in rows:
        off |= got[rows.index("active")] != want[rows.index("active")]
    share = float(off.float().mean())
    d_freq = float((got[rows.index("freq")]
                    - want[rows.index("freq")]).abs().max()
                   ) if "freq" in rows else 0.0
    err = float(rel[:, ~off].max()) if not bool(off.all()) else float("inf")
    log(f"[{rec.label}] {name}: sites stopping at another pass "
        f"{share:.3g} of {off.numel()}, freq max diff {d_freq:.3g}")
    if share > MAF_FLIP_SHARE or d_freq > MAF_FREQ_ATOL or err > MAF_RTOL:
        fail(f"{name} [{rec.label}]: {share} of the sites off, freq diff "
             f"{d_freq}, values {err}")
    return max(err, d_freq)


def check_maf_kernels(torch, dev, prep, p_slab, rec, timer, slab=True,
                      p_sites=None, gl_lin=None):
    """The est_maf kernels against their plain versions on the gl slabs of
    `prep` and the raw posterior slab `p_slab` (fw_post's output, so exact
    1.0 posteriors occur). slab=False: the exact kernel only (no macro
    schedule below 32 individuals). p_sites / gl_lin: also hold the public
    functions against ops/maf.est_maf on the [S, N] arrays. On bfloat16
    slabs kernels A and B are recorded as their "_bf16" exports, the
    window (the same kernel) is checked but not recorded again, and the
    exact kernel, which reads float32 gl only, is left out."""
    from ngsf_hmm_tpu_torch.ops import maf as tmaf
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
    from ngsf_hmm_tpu_torch.ops.hwe import check_interv
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    g0, g2 = prep["g0"], prep["g2"]
    sfx = cuda_lib.gl_suffix(g0, g2, rec.label)
    bs, nb, N = g0.shape
    sites = bs * nb
    cells = sites * N
    slab_b = cells * 4
    gl_b = 2 * cells * g0.element_size()  # the two gl slabs
    fc = FLOPS_CELL
    total = lambda tally: float(torch.stack(tally).sum())

    if slab:
        K0, M = tmaf.macro_schedule(N)
        Ms = tmaf.macro_rounds(K0, M)
        # ---- kernel A
        a_k, ms = timer(lambda: mk._k_maf_state_grad(g0, g2, p_slab, K0))
        tally = []
        a_p, pms = timer(lambda: mk._state_grad_plain(g0, g2, p_slab, K0,
                                                      tally),
                         reps=1, warm=0)
        err = maf_compare(torch, rec, "maf_state_grad" + sfx, a_k, a_p,
                          ["freq", "num", "den", "active", "cn", "cd", "dcn",
                           "dcd"])
        rec.record("maf_state_grad" + sfx, err, ms, pms,
                   gl_b + slab_b + 8 * sites * 4,
                   cells * (fc["maf_planes"] + fc["maf_grad"])
                   + total(tally) * N * fc["maf_pass"])
        # ---- the rounds of one est_maf_slab call, each piece on the
        # kernels' own state: window, then kernel B at the advanced freq
        st, grads, passes = a_k[:4], a_k[4:], K0
        for r, M_r in enumerate(Ms):
            if r > 0:
                fq = st[0].contiguous()
                b_k, ms = timer(lambda: mk._k_maf_sums_grad(g0, g2, p_slab,
                                                            fq))
                b_p, pms = timer(lambda: mk._sums_grad_plain(g0, g2, p_slab,
                                                             fq),
                                 reps=1, warm=0)
                if r == 1:
                    err = maf_compare(torch, rec, "maf_sums_grad" + sfx, b_k,
                                      b_p, ["cn", "cd", "dcn", "dcd"])
                    rec.record(
                        "maf_sums_grad" + sfx, err, ms, pms,
                        gl_b + slab_b + 5 * sites * 4,
                        cells * (fc["maf_planes"] + fc["maf_grad"]))
                grads = b_k
            w_k, ms = timer(lambda: mk._k_maf_window(st, grads, passes, M_r))
            tally = []
            w_p, pms = timer(lambda: mk._virtual_window_plain(
                st, grads, passes, M_r, tally), reps=1, warm=0)
            err = maf_compare(torch, rec, f"maf_window (M = {M_r})", w_k,
                              w_p, ["freq", "num", "den", "active"])
            # the line keeps the last (longest) window's times
            if not sfx:
                rec.record("maf_window", err, ms, pms, 12 * sites * 4,
                           total(tally) * fc["maf_window_step"])
            st, passes = w_k, passes + M_r
        freq_k = mk.est_maf_slab(prep, p_slab)
        if not torch.equal(freq_k, mk._site_vector(st[0], prep)):
            fail(f"[{rec.label}] est_maf_slab differs from its pieces")
        if p_sites is not None:
            want = tmaf.est_maf(gl_lin, p_sites, linear=True, macro=True)
            d = float((freq_k - want).abs().max())
            log(f"[{rec.label}] est_maf_slab against ops/maf.est_maf(macro) "
                f"on [S, N]: max diff {d:.3g}")
            if d > MAF_FREQ_ATOL:
                fail(f"[{rec.label}] est_maf_slab off est_maf by {d}")

    if sfx:
        return
    # ---- the exact fixed point (reads the posterior through the snap)
    e_k, ms = timer(lambda: mk._k_maf_exact(g0, g2, p_slab, True), reps=1)
    tally = []
    e_p, pms = timer(lambda: mk._exact_plain(g0, g2, p_slab, True, tally),
                     reps=1, warm=0)
    err = maf_compare(torch, rec, "maf_exact", e_k[None], e_p[None],
                      ["freq"])
    rec.record("maf_exact", err, ms, pms, 3 * slab_b + sites * 4,
               cells * fc["maf_planes"]
               + total(tally) * N * fc["maf_pass_fma"])
    log(f"[{rec.label}] maf_exact: {total(tally) / sites:.1f} passes a site")
    if p_sites is not None:
        want = tmaf.est_maf(gl_lin, check_interv(p_sites), linear=True)
        d = float((mk._site_vector(e_k, prep) - want).abs().max())
        log(f"[{rec.label}] est_maf_exact against ops/maf.est_maf on "
            f"[S, N]: max diff {d:.3g}")
        if d > MAF_FREQ_ATOL:
            fail(f"[{rec.label}] est_maf_exact off est_maf by {d}")


def probe_fmad(torch, prep, p_slab, timer, label):
    """The est_maf kernels built with FMA contraction (-fmad=true) timed
    beside the build the package runs (-fmad=false, kept for the chain
    kernels' bit identity), in turns on the same inputs; and how far
    contraction moves the freq. A measurement only: nothing is gated and
    the package never loads this second library."""
    from ngsf_hmm_tpu_torch.ops import maf as tmaf
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    flags = tuple("-fmad=true" if f == "-fmad=false" else f
                  for f in cuda_lib.NVCC_FLAGS)
    libs = {"-fmad=false": cuda_lib.load(), "-fmad=true": cuda_lib.load(flags)}
    g0, g2 = prep["g0"], prep["g2"]
    bs, nb, N = g0.shape
    K0, _ = tmaf.macro_schedule(N)
    G, C = mk.state_grad_geometry(N)
    a = torch.empty((8, bs, nb), dtype=torch.float32, device=g0.device)
    b = torch.empty((4, bs, nb), dtype=torch.float32, device=g0.device)
    e = torch.empty((bs, nb), dtype=torch.float32, device=g0.device)
    ptr = (g0.data_ptr(), g2.data_ptr(), p_slab.data_ptr())

    def calls(lib):
        return {
            "maf_state_grad": lambda: lib.ngsf_maf_state_grad(
                *ptr, a.data_ptr(), bs * nb, N, K0, G, C, cuda_lib.stream()),
            "maf_sums_grad": lambda: lib.ngsf_maf_sums_grad(
                *ptr, a[0].data_ptr(), b.data_ptr(), bs * nb, N,
                cuda_lib.stream()),
            "maf_exact": lambda: lib.ngsf_maf_exact(
                *ptr, e.data_ptr(), bs * nb, N, 1, *mk.exact_geometry(N),
                cuda_lib.stream()),
        }

    freqs = {}
    for name in ("maf_state_grad", "maf_sums_grad", "maf_exact"):
        ms = {}
        for flag in ("-fmad=false", "-fmad=true", "-fmad=true",
                     "-fmad=false"):
            rc, t = timer(calls(libs[flag])[name])
            cuda_lib.check(rc, f"{name} {flag}")
            ms.setdefault(flag, []).append(t)
            if name == "maf_exact":
                freqs[flag] = e.clone()
        log(f"[{label}] {name}: -fmad=false "
            + ", ".join(f"{t:.3f}" for t in ms["-fmad=false"])
            + " ms; -fmad=true "
            + ", ".join(f"{t:.3f}" for t in ms["-fmad=true"]) + " ms")
    d = float((freqs["-fmad=true"] - freqs["-fmad=false"]).abs().max())
    log(f"[{label}] maf_exact freq, contraction on against off: max diff "
        f"{d:.3g}")


_chain_lib = []


def probe_chain(torch, timer, S, N, compat):
    """Device time of Viterbi's forward chain alone (CHAIN_PROBE_CU) at S
    sites and N individuals, built with the package's nvcc flags. A
    measurement only: nothing is gated."""
    import ctypes

    from ngsf_hmm_tpu_torch.utils import cuda_lib

    if not _chain_lib:
        d = cuda_lib.build_dir()
        d.mkdir(parents=True, exist_ok=True)
        src, so = d / "chain_probe.cu", d / "chain_probe.so"
        src.write_text(CHAIN_PROBE_CU)
        subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                        "-I", str(cuda_lib.CSRC), str(src), "-o", str(so)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.chain_probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        _chain_lib.append(lib)
    lib = _chain_lib[0]
    g = torch.Generator().manual_seed(S)
    q = (-torch.rand((N, 6), generator=g) - 0.1).cuda()
    out = torch.empty(N, device="cuda")
    _, ms = timer(lambda: cuda_lib.check(lib.chain_probe(
        q.data_ptr(), out.data_ptr(), S, N, int(compat),
        cuda_lib.stream()), "chain_probe"), reps=3)
    return ms


# The transfer-and-tangent stream (csrc/block_transfer_grad.cu) split into
# its two halves, in the kernel's lane layout (one thread per (block,
# column) lane, CTAs of 128):
#   compute_alone  the site step from registers: one chunk of sites loaded
#                  once, then stepped bs times, each input laundered
#                  through an empty asm so that nothing is hoisted:
#                  ProductRuleLane (the step before the tangent rewrite:
#                  site_load a lane, product-rule tangents, no FMA), and
#                  (compute_alone_own) the kernel's own GradLane with the
#                  prior coefficients computed once, as the kernel does
#                  per (site, block);
#   memory_alone   one pass over the two slabs and the compacts in the
#                  lane-per-thread order of k_block_transfer, 4 sites of
#                  loads a lane in flight (chunk_load), summed so that no
#                  load is dropped; the kernel's own staging alone is its
#                  MEM instantiation.
# Built and timed by probe_transfer. Measurements only.
TRANSFER_PROBE_CU = r"""
#include "block_transfer_grad.cu"

__device__ __forceinline__ void launder(float& v) { asm volatile("" : "+f"(v)); }

struct ProductRuleLane {
    float c00 = 1.f, c01 = 0.f, c10 = 0.f, c11 = 1.f;
    float f00 = 0.f, f01 = 0.f, f10 = 0.f, f11 = 0.f;
    float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
    int ex = 0;
    __device__ __forceinline__ void site(const SiteK& k, float F) {
        float m00, m01, m10, m11;
        site_matrix(k, F, m00, m01, m10, m11);
        const float dxp = k.x > 0.0f ? k.d * k.x : 0.0f;
        const float oe0 = k.onem * k.e0;
        const float oe1 = k.onem * k.e1;
        const float fd = F * dxp;
        const float gd = (1.0f - F) * dxp;
        const float p00 = -fd * k.e0, p01 = fd * k.e1;
        const float p10 = gd * k.e0, p11 = -gd * k.e1;
        const float n00 = c00 * m00 + c01 * m10;
        const float n01 = c00 * m01 + c01 * m11;
        const float n10 = c10 * m00 + c11 * m10;
        const float n11 = c10 * m01 + c11 * m11;
        const float nf00 = (f00 * m00 + f01 * m10) + (c00 * -oe0 + c01 * -oe0);
        const float nf01 = (f00 * m01 + f01 * m11) + (c00 * oe1 + c01 * oe1);
        const float nf10 = (f10 * m00 + f11 * m10) + (c10 * -oe0 + c11 * -oe0);
        const float nf11 = (f10 * m01 + f11 * m11) + (c10 * oe1 + c11 * oe1);
        const float na00 = (a00 * m00 + a01 * m10) + (c00 * p00 + c01 * p10);
        const float na01 = (a00 * m01 + a01 * m11) + (c00 * p01 + c01 * p11);
        const float na10 = (a10 * m00 + a11 * m10) + (c10 * p00 + c11 * p10);
        const float na11 = (a10 * m01 + a11 * m11) + (c10 * p01 + c11 * p11);
        const float sc =
            pow2_scale(fmaxf(max4(n00, n01, n10, n11), NGSF_TINY), ex);
        c00 = n00 * sc; c01 = n01 * sc; c10 = n10 * sc; c11 = n11 * sc;
        f00 = nf00 * sc; f01 = nf01 * sc; f10 = nf10 * sc; f11 = nf11 * sc;
        a00 = na00 * sc; a01 = na01 * sc; a10 = na10 * sc; a11 = na11 * sc;
    }
    __device__ __forceinline__ float sum() const {
        return c00 + c01 + c10 + c11 + f00 + f01 + f10 + f11 + a00 + a01 +
               a10 + a11 + (float)ex;
    }
};

template <class Src>
__global__ void __launch_bounds__(128) compute_alone(
        Src src, const float* Fp, const float* ap, float* out, int bs, int nb,
        int N) {
    const long long lanes = (long long)nb * N;
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int j = (int)(lane / N);
    const int n = (int)(lane - (long long)j * N);
    const float F = Fp[n], a = ap[n];
    float l0[NGSF_UNROLL], l2[NGSF_UNROLL], ff[NGSF_UNROLL], dd[NGSF_UNROLL];
    chunk_load(src, 0, bs, nb, j, lane, lanes, l0, l2, ff, dd);
    ProductRuleLane L;
    for (int r0 = 0; r0 < bs; r0 += NGSF_UNROLL) {
#pragma unroll
        for (int u = 0; u < NGSF_UNROLL; ++u) {
            launder(l0[u]); launder(l2[u]); launder(ff[u]); launder(dd[u]);
            L.site(src.site(l0[u], l2[u], ff[u], dd[u], a), F);
        }
    }
    out[lane] = L.sum();
}

template <class Src>
__global__ void __launch_bounds__(128) memory_alone(
        Src src, float* out, int bs, int nb, int N) {
    const long long lanes = (long long)nb * N;
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int j = (int)(lane / N);
    float s = 0.0f;
    for (int r0 = 0; r0 < bs; r0 += NGSF_UNROLL) {
        float l0[NGSF_UNROLL], l2[NGSF_UNROLL], ff[NGSF_UNROLL],
            dd[NGSF_UNROLL];
        chunk_load(src, r0, bs, nb, j, lane, lanes, l0, l2, ff, dd);
#pragma unroll
        for (int u = 0; u < NGSF_UNROLL; ++u) s += l0[u] + l2[u] + ff[u] + dd[u];
    }
    out[lane] = s;
}

// The kernel's own step (GradLane) from registers; the prior coefficients,
// which the kernel computes once per (site, block), are computed once here
// and laundered at every site.
template <class Src>
__global__ void __launch_bounds__(128) compute_alone_own(
        Src src, const float* Fp, const float* ap, float* out, int bs, int nb,
        int N) {
    const long long lanes = (long long)nb * N;
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int j = (int)(lane / N);
    const int n = (int)(lane - (long long)j * N);
    const float F = Fp[n], a = ap[n];
    float l0[NGSF_UNROLL], l2[NGSF_UNROLL], ff[NGSF_UNROLL], dd[NGSF_UNROLL];
    chunk_load(src, 0, bs, nb, j, lane, lanes, l0, l2, ff, dd);
    Prior q[NGSF_UNROLL];
#pragma unroll
    for (int u = 0; u < NGSF_UNROLL; ++u) q[u] = site_prior(ff[u]);
    GradLane L;
    for (int r0 = 0; r0 < bs; r0 += NGSF_UNROLL) {
#pragma unroll
        for (int u = 0; u < NGSF_UNROLL; ++u) {
            launder(l0[u]); launder(l2[u]); launder(dd[u]);
            if (Src::kFreq) {
                launder(q[u].i0); launder(q[u].pr0); launder(q[u].pq2);
                launder(q[u].pr2); launder(q[u].s10); launder(q[u].het);
                launder(q[u].s12);
                L.site(site_emit(l0[u], l2[u], q[u], dd[u], a), F);
            } else {
                L.site(site_em(l0[u], l2[u], dd[u], a), F);
            }
        }
    }
    out[lane] = L.c00 + L.c01 + L.c10 + L.c11 + L.f00 + L.f01 + L.f10 +
                L.f11 + L.a00 + L.a01 + L.a10 + L.a11 + (float)L.ex;
}

template <class Src>
static int run_probe(int kind, Src src, const float* F, const float* al,
                     float* out, int bs, int nb, int N, void* st) {
    const long long lanes = (long long)nb * N;
    const unsigned grid = (unsigned)((lanes + 127) / 128);
    cudaStream_t s = (cudaStream_t)st;
    switch (kind) {
    case 0: compute_alone<<<grid, 128, 0, s>>>(src, F, al, out, bs, nb, N); break;
    case 4: memory_alone<<<grid, 128, 0, s>>>(src, out, bs, nb, N); break;
    // the kernel's own step, and its staged loads alone
    case 1: compute_alone_own<<<grid, 128, 0, s>>>(src, F, al, out, bs, nb, N); break;
    case 2: return launch<Src, true>(src, F, al, out, bs, nb, N, st);
    default: return -1;
    }
    return (int)cudaGetLastError();
}

// source: 0 float32 gl, 1 bfloat16 gl, 2 emission slabs (v1)
extern "C" int transfer_probe(int kind, int source, const void* a,
                              const void* b, const float* fc, const float* dc,
                              const float* F, const float* al, float* out,
                              int bs, int nb, int N, void* st) {
    if (source == 0)
        return run_probe(kind, GlSource<float>{(const float*)a, (const float*)b, fc, dc},
                         F, al, out, bs, nb, N, st);
    if (source == 1)
        return run_probe(kind, GlSource<__nv_bfloat16>{(const __nv_bfloat16*)a,
                                                        (const __nv_bfloat16*)b, fc, dc},
                         F, al, out, bs, nb, N, st);
    return run_probe(kind, EmSource{(const float*)a, (const float*)b, nullptr, dc},
                     F, al, out, bs, nb, N, st);
}
"""

# H100 SM resources for the residency arithmetic of probe_build (CUDA
# occupancy rules for compute capability 9.0).
SM_COUNT = 132
SM_REGS_PER_PARTITION = 16384  # 4 partitions of the 65,536 registers
SM_MAX_WARPS, SM_MAX_CTAS = 64, 32
SM_SMEM = 233472  # bytes of shared memory an SM gives its CTAs
CTA_SMEM_RESERVED = 1024


def resident_ctas(regs, threads, smem=0):
    """CTAs of `threads` threads an SM holds at `regs` registers a thread
    and `smem` bytes of shared memory a CTA: the least of the register,
    warp, CTA and shared-memory limits."""
    warps = -(-threads // 32)
    per_warp = -(-max(regs, 1) * 32 // 256) * 256
    by_regs = 4 * (SM_REGS_PER_PARTITION // per_warp) // warps
    by_smem = SM_SMEM // (smem + CTA_SMEM_RESERVED)
    return min(by_regs, SM_MAX_WARPS // warps, SM_MAX_CTAS, by_smem)


def _sass_loops(sass):
    """Per function of a cuobjdump -sass listing: its instruction count, its
    loops (a backward branch and its target), each as (instructions,
    opcode counts), largest first, the largest loop's instructions outside
    the loops nested in it, and the loops with their ranges
    (instructions, opcode counts, first, last)."""
    import re

    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), {"ins": [], "labels": {}})
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            cur["labels"][m.group(1)] = len(cur["ins"])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            cur["ins"].append((int(m.group(1), 16), text))
    out = {}
    for name, f in funcs.items():
        ins = f["ins"]
        addr = {a: i for i, (a, _) in enumerate(ins)}
        loops = []
        for i, (a, text) in enumerate(ins):
            if not text.startswith("BRA"):
                continue
            m = re.search(r"`?\(?(\.L_x_\d+)\)?`?", text)
            if m and m.group(1) in f["labels"]:
                t = f["labels"][m.group(1)]
            else:
                m = re.search(r"(0x[0-9a-f]+)", text)
                t = addr.get(int(m.group(1), 16)) if m else None
            if t is None or t >= i:
                continue
            body = [x.split()[0] for _, x in ins[t:i + 1]]
            ops = {}
            for op in body:
                key = op.split(".")[0]
                ops[key] = ops.get(key, 0) + 1
            loops.append((len(body), ops, t, i))
        loops.sort(key=lambda x: -x[0])
        # the largest loop's instructions outside the loops nested in it
        flat = 0
        if loops:
            _, _, t0, i0 = loops[0]
            inner = [(t, i) for _, _, t, i in loops[1:] if t0 <= t and i <= i0]
            flat = sum(1 for q in range(t0, i0 + 1)
                       if not any(t <= q <= i for t, i in inner))
        out[name] = (len(ins), [lp[:2] for lp in loops], flat, loops)
    return out


PROBE_SOURCES = ("block_transfer_grad.cu", "block_transfer.cu",
                 "maf_state_grad.cu", "maf_exact.cu", "maf_macro.cu")
# probe_build prints these two for the instantiation each shape uses only
MAF_PROBE_SOURCES = ("maf_exact.cu", "maf_macro.cu")


def _maf_geometry(kernel, args, N):
    """(sites a warp, sites whose windows one warp carries) of a maf_exact
    or maf_macro instantiation with template arguments `args`, or None
    if N individuals would not run it. The segment kernels' arguments
    are (G, C[, T]) (exact_geometry / state_grad_geometry); a tree whose
    kernels give a site one warp has (CPL[, T]), CPL chosen from N as its
    NGSF_MAF_DISPATCH did; every warp there runs its own site's windows."""
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk

    ints = [int(a.replace("(int)", "")) for a in args
            if a.replace("(int)", "").strip().lstrip("-").isdigit()]
    if len(ints) >= 2:
        pick = (mk.exact_geometry if kernel == "exact"
                else mk.state_grad_geometry)(N)
        if tuple(ints[:2]) != tuple(pick):
            return None
        spw = 32 // ints[0]
        return spw, spw * 8
    cpl = 1 if N <= 32 else 2 if N <= 64 else 4 if N <= 128 else 0
    return (1, 1) if ints == [cpl] else None


def maf_probe_line(nice, props, loops, shapes):
    """probe_build's line for a maf_exact or maf_macro instantiation at
    each shape that runs it: registers, spills, resident CTAs, waves, the
    SASS of a pass (the pass loop, both reciprocal paths: an upper
    estimate) for the sites of a warp and, for maf_macro, of a gradient
    round outside its window and of a window step, and the issue floor:
    those instructions at the shape's full schedule (ITER_MAX + 1 passes
    for maf_exact; K0 passes, every gradient round and window step for
    maf_macro: an upper estimate of the work) over 4 warp instructions a
    cycle on 132 SMs at the highest SM clock."""
    import re

    m = re.search(r"k_maf_(exact|macro)<([^>]*)>", nice)
    if not m or not loops:
        return
    kernel, args = m.group(1), m.group(2).split(",")
    n_ins, _, _, lps = loops
    nested = lambda a, b: a[2] <= b[2] and b[3] <= a[3] and a != b
    top = [lp for lp in lps if not any(nested(o, lp) for o in lps)]
    flat = lambda lp: sum(1 for q in range(lp[2], lp[3] + 1) if not any(
        o[2] <= q <= o[3] for o in lps if nested(lp, o)))
    for label, sh in shapes.items():
        if (kernel == "exact") != ("passes" in sh) or (
                "bfloat16" in nice) != sh.get("bf16", False):
            continue
        geo = _maf_geometry(kernel, args, sh["N"])
        if geo is None:
            continue
        spw, spb = geo
        warps = -(-sh["sites"] // spw)
        blocks = -(-warps // 8)
        ctas = resident_ctas(props["regs"], 256, props["smem"])
        rate = 4 * SM_COUNT * SM_CLOCK_MHZ * 1e3  # warp instructions a ms
        if kernel == "exact":
            pas = flat(max(top, key=lambda lp: lp[0]))
            work = f"pass loop {pas} SASS for {spw} sites"
            floor = pas * warps * sh["passes"] / rate
            sched = f"{sh['passes']} passes a site"
        else:
            rnd = [lp for lp in top if any(nested(lp, o) for o in lps)]
            if not rnd:
                continue
            rnd = max(rnd, key=lambda lp: lp[0])
            win = max((o for o in lps if nested(rnd, o)), key=lambda o: o[0])
            pas = max((lp for lp in top if lp is not rnd),
                      key=lambda lp: lp[0], default=None)
            pas = flat(pas) if pas else 0
            grad, step = flat(rnd), flat(win)
            K0, Ms = sh["K0"], sh["Ms"]
            # a window step serves spb sites (one warp a block) or one
            steps = blocks if spb > 1 else sh["sites"]
            floor = (pas * warps * K0 + grad * warps * len(Ms)
                     + step * steps * sum(Ms)) / rate
            work = (f"pass loop {pas} SASS for {spw} sites, gradient round "
                    f"{grad} for {spw}, window step {step} for {spb}")
            sched = f"K0 = {K0}, windows {Ms}"
        log(f"[probe build] {nice[:80]} at {label} ({sh['sites']} x "
            f"{sh['N']}): {props['regs']} registers, spills "
            f"{props.get('spill', (0, 0))}, smem {props['smem']} B; {ctas} "
            f"CTAs of 256 an SM ({blocks / (SM_COUNT * ctas):.2f} waves); "
            f"{n_ins} SASS instructions; {work}; issue floor "
            f"{floor:.3f} ms at the full schedule ({sched})")


def probe_build(lanes_by_source, csrc=None):
    """For each source of PROBE_SOURCES: nvcc -Xptxas -v (registers,
    spills, shared memory of each instantiation) and cuobjdump -sass of
    the same cubin (instructions of each loop, largest first, with the
    commonest opcodes). Prints the resident CTAs an SM and the waves over
    132 SMs at the lane (thread) counts given per source. A measurement
    only: nothing is gated. csrc: another tree's csrc directory (the
    parent's, to compare) in place of the package's."""
    import pathlib
    import re
    import shutil

    from ngsf_hmm_tpu_torch.utils import cuda_lib

    csrc = pathlib.Path(csrc or cuda_lib.CSRC)
    d = cuda_lib.build_dir() / "probe_build"
    d.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_lib._nvcc()
    dump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc), "cuobjdump")
    filt = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(nvcc), "cu++filt")
    procs = []
    for src in PROBE_SOURCES:
        cubin = d / (src + ".cubin")
        procs.append((src, cubin, subprocess.Popen(
            [nvcc, *cuda_lib.NVCC_FLAGS, "-cubin", "-Xptxas", "-v", "-I",
             str(csrc), str(csrc / src), "-o", str(cubin)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for src, cubin, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            log(f"[probe build] {src}: nvcc failed:\n{err}")
            continue
        props, cur = {}, None
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = props.setdefault(m.group(1), {})
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                cur = props.setdefault(m.group(1), {})
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                cur["spill"] = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["regs"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                cur["smem"] = int(m.group(1)) if m else 0
        sass = subprocess.run([dump, "-sass", str(cubin)], capture_output=True,
                              text=True).stdout
        (d / (src + ".sass")).write_text(sass)
        loops = _sass_loops(sass)
        names = list(props)
        try:
            pretty = subprocess.run([filt], input="\n".join(names),
                                    capture_output=True, text=True,
                                    check=True).stdout.splitlines()
        except (OSError, subprocess.CalledProcessError):
            pretty = names
        for name, nice in zip(names, pretty):
            p = props[name]
            if "regs" not in p:
                continue
            shapes = lanes_by_source.get(src, {})
            if src in MAF_PROBE_SOURCES:
                maf_probe_line(nice, p, loops.get(name), shapes)
                continue
            n_ins, lp, flat, _ = loops.get(name, (0, [], 0, []))
            threads = 256 if "maf" in src else 128
            # the staged transfer kernel's dynamic shared memory: three
            # tiles of 8 sites x 128 lanes of both slabs, 3 blocks' compacts
            smem = p["smem"]
            staged = "k_block_transfer_grad" in nice and "(bool)" in nice
            if staged:
                esz = 2 if "bfloat16" in nice else 4
                smem += 3 * 2 * 8 * 128 * esz + 4 * 3 * 2 * 3 * 8 + (
                    3 * 8 * 32 if "GlSource" in nice else 0)
            ctas = resident_ctas(p["regs"], threads, smem)
            waves = ", ".join(
                f"{k} {v[0] / (SM_COUNT * ctas * threads):.2f} waves"
                for k, v in shapes.items()) if ctas else "not resident"
            top = "; ".join(
                f"{n} ins [" + ", ".join(
                    f"{o} {c}" for o, c in sorted(ops.items(),
                                                   key=lambda x: -x[1])[:8])
                + "]" for n, ops in lp[:3] if n >= 8)
            floor = ""
            if "k_block_transfer" in nice and flat:
                # the loop body holds NGSF_TG_D = 8 sites (the staged
                # kernel) or NGSF_UNROLL = 4 (a lane-per-thread kernel)
                per = flat / (8 if staged else 4)
                floor = f"; {per:.1f} SASS instructions a site (the loop " \
                    f"body outside its nested loops), issue floor " + ", ".join(
                        f"{k} {per * v[1] / 32 / (4 * SM_COUNT * SM_CLOCK_MHZ * 1e3):.3f} ms"
                        for k, v in shapes.items())
            log(f"[probe build] {nice[:110]}: {p['regs']} registers, spills "
                f"{p.get('spill', (0, 0))}, smem {smem} B; "
                f"{ctas} CTAs of {threads} an SM ({waves}); {n_ins} SASS "
                f"instructions, loops: {top or 'none'}{floor}")


_transfer_lib = []


def probe_transfer(torch, timer, label, sl, F_t, a_t, v1):
    """The transfer-and-tangent kernel beside its two halves
    (TRANSFER_PROBE_CU) on the same slabs, in turns: the kernel, the step
    from registers (the product-rule step and the kernel's own), the
    loads alone (in the lane order, and the kernel's own staging);
    Prints each time and the loads' rate. A measurement only: nothing is
    gated."""
    import ctypes

    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
    from ngsf_hmm_tpu_torch.models import hmm_kernels_v1 as h1
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    if not _transfer_lib:
        d = cuda_lib.build_dir()
        d.mkdir(parents=True, exist_ok=True)
        src, so = d / "transfer_probe.cu", d / "transfer_probe.so"
        src.write_text(TRANSFER_PROBE_CU)
        subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-I", str(cuda_lib.CSRC), str(src), "-o",
                        str(so)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.transfer_probe.argtypes = [ctypes.c_int] * 2 + \
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        _transfer_lib.append(lib)
    lib = _transfer_lib[0]
    a, b = sl[0], sl[1]
    fc = None if v1 else sl[2]
    dc = sl[-1]
    bs, nb, N = a.shape
    source = 2 if v1 else (1 if a.dtype == torch.bfloat16 else 0)
    out = torch.empty(13 * nb * N, device=a.device)  # a kernel's output
    nbytes = 2 * a.numel() * a.element_size() + dc.numel() * 4 * (
        1 if v1 else 2)

    def probe(kind):
        return lambda: cuda_lib.check(lib.transfer_probe(
            kind, source, a.data_ptr(), b.data_ptr(),
            0 if fc is None else fc.data_ptr(), dc.data_ptr(),
            F_t.data_ptr(), a_t.data_ptr(), out.data_ptr(), bs, nb, N,
            cuda_lib.stream()), f"transfer_probe {kind}")

    kern = (lambda: h1._k_block_transfer_grad_v1(*sl, F_t, a_t)) if v1 else (
        lambda: hk._k_block_transfer_grad(*sl, F_t, a_t))
    runs = {"kernel": kern, "step from registers (product rule)": probe(0),
            "loads alone, lane order, 4 sites in flight": probe(4),
            "step from registers (the kernel's own)": probe(1),
            "loads alone, the kernel's staging": probe(2)}
    ms = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            ms[k].append(timer(runs[k])[1])
    parts = []
    for k, ts in ms.items():
        t = min(ts)
        rate = (f", {nbytes / t / 1e9:.3f} TB/s" if "loads" in k else "")
        parts.append(f"{k} {t:.3f} ms{rate}")
    log(f"[{label}] transfer-and-tangent split (lanes {nb * N}, bs {bs}): "
        + "; ".join(parts))


def probe_lanes(S, N, S_c, R=20):
    """(threads, cells) of a launch of each PROBE_SOURCES kernel: a lane
    per (block, column) for the stream kernels at the main path's shape
    and at the restart path's (R replicates of the check shape), G lanes
    a site for kernel A at the main path's shape; for maf_exact the exact
    path's shape (S_c x 20) and for maf_macro the main path's (float32 and
    bfloat16 slabs), each with its schedule (maf_probe_line)."""
    from ngsf_hmm_tpu_torch.models.hmm_kernels import pick_geom2
    from ngsf_hmm_tpu_torch.ops.maf import macro_rounds, macro_schedule
    from ngsf_hmm_tpu_torch.ops.maf_kernels import state_grad_geometry
    from ngsf_hmm_tpu_torch.utils.constants import ITER_MAX

    bs, nb = pick_geom2(S, N)
    bs_r, nb_r = pick_geom2(S_c, R * N)
    stream = {"main": (nb * N, bs * nb * N),
              "restart": (nb_r * R * N, bs_r * nb_r * R * N)}
    K0, M = macro_schedule(N)
    macro = dict(sites=S, N=N, K0=K0, Ms=macro_rounds(K0, M))
    return {"block_transfer_grad.cu": stream, "block_transfer.cu": stream,
            "maf_state_grad.cu": {
                "main": (bs * nb * state_grad_geometry(N)[0], bs * nb * N)},
            "maf_exact.cu": {"exact": dict(sites=S_c, N=20,
                                           passes=ITER_MAX + 1)},
            "maf_macro.cu": {"main": macro,
                             "main bf16": dict(macro, bf16=True)}}


def run_probes(torch, dev, args, R=20):
    """--probes: check_streams and probe_transfer at the main path's shape
    (float32 and bfloat16 gl slabs) and at the restart path's (R
    replicates of the check shape's emissions, the _v1 export), and
    probe_fmad at the main path's shape; prints no result and returns
    4."""
    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
    from ngsf_hmm_tpu_torch.models import hmm_kernels_v1 as h1

    f32 = torch.float32
    timer = Timer(torch, dev)
    gl, dist, freq, F0, a0 = simulate(args.sites, args.ind, args.seed)
    gl_t = torch.exp(torch.as_tensor(gl).to(dev, f32))
    del gl
    dist_t = torch.as_tensor(dist).to(dev, f32)
    F_t = torch.as_tensor(F0).to(dev, f32)
    a_t = torch.as_tensor(a0).to(dev, f32)
    prep = hk.prepare_gl_inputs(gl_t, dist_t)
    fc = hk.freq_compact(torch.as_tensor(freq).to(dev, f32), prep)
    sl = (prep["g0"], prep["g2"], fc, prep["dc"])
    rec = Recorder(torch, "main shape", {})
    p_slab = check_streams(torch, dev, rec, timer, "main shape", sl, F_t,
                           a_t, False)
    check_maf_kernels(torch, dev, prep, p_slab, rec, timer)
    probe_transfer(torch, timer, "main shape", sl, F_t, a_t, False)
    probe_fmad(torch, prep, p_slab, timer, "main shape")
    del prep, p_slab
    prep = hk.prepare_gl_inputs(gl_t, dist_t, gl_dtype=torch.bfloat16)
    sl = (prep["g0"], prep["g2"], fc, prep["dc"])
    rec = Recorder(torch, "main shape bf16", {})
    check_maf_kernels(torch, dev, prep, check_streams(
        torch, dev, rec, timer, rec.label, sl, F_t, a_t, False), rec, timer)
    probe_transfer(torch, timer, "main shape bf16", sl, F_t, a_t, False)
    del prep, gl_t
    # the restart shape as main() checks it: R random replicate inits of
    # the check shape's data, flattened into R * N columns
    from ngsf_hmm_tpu_torch.models.restart import (flatten_states,
                                                   stack_restart_states)
    gl, dist, _, _, _ = simulate(args.check_sites, args.ind, args.seed + 7,
                                 n_chrom=1)
    step = max(2, min(100_000, args.check_sites // 2))
    dist[step::step] = np.inf
    flat = flatten_states(stack_restart_states(gl, R, args.seed + 5,
                                               device=dev))
    prep = h1.prepare_inputs(flat.e_prob, torch.as_tensor(dist).to(dev, f32))
    sl = (prep["e0"], prep["e1"], prep["dc"])
    F_t, a_t = flat.indF.contiguous(), flat.alpha.contiguous()
    del flat
    label = f"restart shape R={R}"
    check_streams(torch, dev, Recorder(torch, label, {}), timer, label, sl,
                  F_t, a_t, True)
    probe_transfer(torch, timer, label, sl, F_t, a_t, True)
    del prep, sl
    check_maf_shapes(torch, dev, {}, args.seed, 20_011)
    log("probes done; no result is printed for them")
    return 4


def maf_rows_inputs(torch, dev, gl, dist, freq, F, alpha, raw=False):
    """What the LD path's freq M-step reads at this shape: the linear gl
    planes (maf_kernels.gl_rows) and the snapped posterior [S, N] that the
    chain kernels give at (freq, F, alpha); also the gl-slab prep and the
    snapped posterior slab, est_maf_slab's view of the same data. raw=True
    also returns the posterior unsnapped, [S, N] and as the slab (what
    the main path's freq M-step reads)."""
    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
    from ngsf_hmm_tpu_torch.ops.hwe import check_interv

    f32 = torch.float32
    gl_t = torch.as_tensor(gl).to(dev, f32)
    prep = hk.prepare_gl_inputs(torch.exp(gl_t),
                                torch.as_tensor(dist).to(dev, f32))
    p_sites, _, _, p_slab = hk.posteriors_fused(
        torch.as_tensor(F).to(dev, f32), torch.as_tensor(alpha).to(dev, f32),
        prep, hk.freq_compact(torch.as_tensor(freq).to(dev, f32), prep),
        return_slab=True)
    out = (mk.gl_rows(gl_t), check_interv(p_sites).contiguous(), prep,
           check_interv(p_slab))
    return out + (p_sites, p_slab) if raw else out


def exact_shape_inputs(torch, dev, S, N, seed):
    """The exact path's data (simulate at S x N, two chromosomes) and what
    its freq M-step reads from the chain kernels at the initial
    parameters: (simulate's tuple, the float32 log gl [S, N, 3] on the
    card, the gl-slab prep, the raw posterior [S, N] and slab)."""
    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk

    f32 = torch.float32
    data = simulate(S, N, seed, n_chrom=2)
    gl_x, dist_x, freq_x, F0_x, a0_x = data
    gl_t = torch.as_tensor(gl_x).to(dev, f32)
    prep = hk.prepare_gl_inputs(torch.exp(gl_t),
                                torch.as_tensor(dist_x).to(dev, f32))
    p_sites, _, _, p_slab = hk.posteriors_fused(
        torch.as_tensor(F0_x).to(dev, f32), torch.as_tensor(a0_x).to(dev, f32),
        prep, hk.freq_compact(torch.as_tensor(freq_x).to(dev, f32), prep),
        return_slab=True)
    return data, gl_t, prep, p_sites, p_slab


# est_maf kernels against ops/maf.est_maf on float64 copies of what they
# read (f64_anchor): results by "[shape] function"; MAF_F64_STEP: a freq
# further than this from float64 counts as a site that stopped at another
# pass than float64 (a damped step there is about EPSILON)
ANCHORS = {}
MAF_F64_STEP = 1e-6


def f64_anchor(torch, label, name, freq, g0, g2, p, macro):
    """The distance of an est_maf function's freq [S] from ops/maf.est_maf
    (linear, exact or macro=True) run in float64 on float64 copies of the
    linear gl planes g0 / g2 [S, N] and the posterior p [S, N] it read
    (snapped already where the function snaps): the largest and the mean
    absolute difference and the share of sites further than
    MAF_F64_STEP (stopped at another pass than float64). Logs and keeps
    them in ANCHORS; fails if a freq is further than MAF_FREQ_ATOL (a site
    that stops at another pass moves by one damped step, less than that).
    The share is information: it depends on the data."""
    from ngsf_hmm_tpu_torch.ops import maf as tmaf

    d64 = torch.float64
    g0d, g2d = g0.to(d64), g2.to(d64)
    want = tmaf.est_maf(torch.stack((g0d, 1.0 - g0d - g2d, g2d), -1),
                        p.to(d64), linear=True, macro=macro)
    del g0d, g2d
    d = (freq.to(d64) - want).abs()
    r = dict(max=float(d.max()), mean=float(d.mean()),
             share=float((d > MAF_F64_STEP).double().mean()))
    ANCHORS[f"[{label}] {name}"] = r
    log(f"[{label}] {name} against ops/maf.est_maf in float64 "
        f"({'macro' if macro else 'exact'}): freq max diff {r['max']:.4g}, "
        f"mean {r['mean']:.4g}, sites further than {MAF_F64_STEP:g}: "
        f"{r['share']:.4g}")
    if r["max"] > MAF_FREQ_ATOL:
        fail(f"[{label}] {name}: freq {r['max']} from float64")


def anchor_exact(torch, label, gl_t, prep, p_sites, p_slab):
    """est_maf_exact (maf_exact, snapping the raw posterior slab) against
    float64 at the exact path's shape."""
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
    from ngsf_hmm_tpu_torch.ops.hwe import check_interv

    g0, g2 = mk.gl_rows(gl_t)
    f64_anchor(torch, label, "est_maf_exact", mk.est_maf_exact(prep, p_slab),
               g0, g2, check_interv(p_sites), False)


def anchor_macro(torch, rows, p_m, prep, p_raw, slab_raw):
    """macro_slab (kernel 9 on main's float32 slabs and raw posterior slab)
    and est_maf_rows (maf_macro on the LD path's rows and snapped
    posterior) against float64 at the main path's shape."""
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk

    g0, g2 = rows
    f64_anchor(torch, "main shape", "macro_slab", mk.macro_slab(
        prep, slab_raw), g0, g2, p_raw, True)
    f64_anchor(torch, "ld shape", "est_maf_rows", mk.est_maf_rows(g0, g2, p_m),
               g0, g2, p_m, True)


def check_maf_shapes(torch, dev, results, seed, S_m, Ns=(40, 32, 130, 300)):
    """The row est_maf kernel (maf_macro) and the slab est_maf kernels
    against their plain versions at S_m sites: a ragged site count at 40
    individuals, the schedule's edge (32), 130 and 300 (kernel A's G = 8,
    16 and 32 lanes a site; above 128 maf_macro recomputes its planes
    from cache, above 256 kernel A does); est_maf_slab's pieces and the
    one-launch slab kernel on float32 and bfloat16 slabs of the same gl.
    The LD path's shape is checked in main."""
    for N_m in Ns:
        gl_m, dist_m, freq_m, F0_m, a0_m = simulate(S_m, N_m, seed + N_m)
        rows, p_m, prep_m, slab_m = maf_rows_inputs(
            torch, dev, gl_m, dist_m, freq_m, F0_m, a0_m)
        rec_m = Recorder(torch, f"macro shape N={N_m}", results)
        check_maf_macro(torch, rows, p_m, rec_m, Timer(torch, dev))
        # the slab kernels on the same snapped posterior, float32 and
        # bfloat16 slabs of the same gl
        for dt in (torch.float32, torch.bfloat16):
            prep = dict(prep_m, g0=prep_m["g0"].to(dt),
                        g2=prep_m["g2"].to(dt))
            check_maf_kernels(torch, dev, prep, slab_m, rec_m,
                              Timer(torch, dev))
            check_macro_slab(torch, prep, slab_m, rec_m, Timer(torch, dev))
        del gl_m, rows, p_m, prep_m, slab_m


# maf_exact's extra shapes: one N for each (G, C) family exact_geometry
# can choose (G = 1 at C = 1 and 7, G = 2, 4, 8, 16, 32, and the planes
# recomputed past 256 individuals)
EXACT_NS = (1, 7, 12, 31, 40, 100, 200, 300)


def check_exact_shapes(torch, dev, results, seed, S_e, Ns=EXACT_NS):
    """maf_exact against its plain version at S_e sites for each N of Ns,
    with snap and without, on simulate's gl and a posterior with cells
    within EPSILON of 0 and of 1 and exact zeros and ones (so the snap
    and the het floor engage). Keeps the largest error in
    results["maf_exact"]."""
    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
    from ngsf_hmm_tpu_torch.utils.constants import EPSILON

    f32 = torch.float32
    err = 0.0
    for N_e in Ns:
        gl, dist, _, _, _ = simulate(S_e, N_e, seed + N_e)
        rng = np.random.default_rng(seed + N_e)
        p = rng.random((S_e, N_e), dtype=np.float32)
        u = rng.random((S_e, N_e))
        p[u < 0.05] *= EPSILON  # within EPSILON of 0
        near1 = (u >= 0.05) & (u < 0.1)
        p[near1] = 1.0 - p[near1] * EPSILON  # within EPSILON of 1
        p[(u >= 0.1) & (u < 0.12)] = 1.0
        p[(u >= 0.12) & (u < 0.13)] = 0.0
        prep = hk.prepare_gl_inputs(
            torch.exp(torch.as_tensor(gl).to(dev, f32)),
            torch.as_tensor(dist).to(dev, f32))
        slab = hk.pack_sites2(torch.as_tensor(p).to(dev), prep, 0.5)
        rec = Recorder(torch, f"exact shape N={N_e} {mk.exact_geometry(N_e)}",
                       {})
        g0, g2 = prep["g0"], prep["g2"]
        for snap in (True, False):
            k = mk._k_maf_exact(g0, g2, slab, snap)
            w = mk._exact_plain(g0, g2, slab, snap)
            err = max(err, maf_compare(
                torch, rec, f"maf_exact (snap {snap})", k.reshape(1, -1),
                w.reshape(1, -1), ["freq"]))
        del gl, prep, slab
    r = results["maf_exact"]
    r["max_abs_err"] = max(r["max_abs_err"], err)


def check_maf_macro(torch, rows, p, rec, timer, slab=None):
    """maf_macro against its plain version on [S, N] rows (rows = (g0, g2),
    p the snapped posterior) at this shape's schedule. slab = (prep,
    p_slab): also time est_maf_rows against est_maf_slab on the same
    snapped posterior and print their difference (information: the two
    routes run the same arithmetic, in one launch or in seven)."""
    from ngsf_hmm_tpu_torch.ops import maf as tmaf
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk

    g0, g2 = rows
    S, N = g0.shape
    K0, M = tmaf.macro_schedule(N)
    Ms = tmaf.macro_rounds(K0, M)
    k, ms = timer(lambda: mk._k_maf_macro(g0, g2, p, K0, Ms))
    tally = {"pass": [], "grad": [], "step": []}
    w, pms = timer(lambda: mk._macro_rows_plain(g0, g2, p, K0, Ms, tally),
                   reps=1, warm=0)
    err = maf_compare(torch, rec, "maf_macro", k[None], w[None], ["freq"])
    work = {kind: float(torch.stack(v).sum()) for kind, v in tally.items()}
    fc = FLOPS_CELL
    rec.record("maf_macro", err, ms, pms, 3 * S * N * 4 + S * 4,
               S * N * fc["maf_planes"] + work["pass"] * N
               * fc["maf_pass_fma"] + work["grad"] * N * fc["maf_grad_fma"]
               + work["step"] * fc["maf_window_step_active"])
    log(f"[{rec.label}] maf_macro: schedule K0 = {K0}, windows {Ms}; per "
        f"site {work['pass'] / S:.2f} real passes, {work['grad'] / S:.2f} "
        f"gradient evaluations, {work['step'] / S:.1f} window steps")
    if slab is not None:
        # the schedule's parts: the real passes alone, then with the
        # gradient rounds (windows of 0 steps), then the whole
        ms_p = timer(lambda: mk._k_maf_macro(g0, g2, p, K0, ()))[1]
        ms_g = timer(lambda: mk._k_maf_macro(g0, g2, p, K0,
                                             (0,) * len(Ms)))[1]
        step_us = (ms - ms_g) * 1e3 / sum(Ms)
        log(f"[{rec.label}] maf_macro split: the {K0} real passes alone "
            f"{ms_p:.3f} ms, with the {len(Ms)} gradient rounds {ms_g:.3f} "
            f"ms, with the windows {ms:.3f} ms ({step_us:.2f} us a window "
            "step)")
        prep, p_slab = slab
        f_slab, ms_slab = timer(lambda: mk.est_maf_slab(prep, p_slab))
        f_rows, ms_rows = timer(lambda: mk.est_maf_rows(g0, g2, p))
        d = float((f_rows - f_slab).abs().max())
        log(f"[{rec.label}] est_maf_rows (maf_macro, 1 launch) {ms_rows:.3f} "
            f"ms against est_maf_slab (kernel A, windows, kernel B: "
            f"{2 * len(Ms)} launches) {ms_slab:.3f} ms on the same "
            f"snapped posterior: freq max diff {d:.3g} (information)")


def check_macro_slab(torch, prep, p_slab, rec, timer):
    """The one-launch slab est_maf (maf_macro.cu on the [bs * nb, N] view
    of the gl slabs of `prep`, float32 or bfloat16) against its plain
    version (_macro_rows_plain on the same view) and, through macro_slab,
    against est_maf_slab on the same slabs and raw posterior slab `p_slab`
    (the same arithmetic in seven launches): freq within MAF_FREQ_ATOL.
    Records maf_macro_slab[_bf16] with its bound from this data's work."""
    from ngsf_hmm_tpu_torch.ops import maf as tmaf
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    g0, g2 = prep["g0"], prep["g2"]
    bs, nb, N = g0.shape
    sites, cells = bs * nb, bs * nb * N
    name = "maf_macro_slab" + cuda_lib.gl_suffix(g0, g2, rec.label)
    K0, M = tmaf.macro_schedule(N)
    Ms = tmaf.macro_rounds(K0, M)
    k, ms = timer(lambda: mk._k_maf_macro_slab(g0, g2, p_slab, K0, Ms))
    rows = lambda t: t.reshape(sites, N)
    tally = {"pass": [], "grad": [], "step": []}
    w, pms = timer(lambda: mk._macro_rows_plain(
        rows(g0), rows(g2), rows(p_slab), K0, Ms, tally,
        name="maf_macro_slab"), reps=1, warm=0)
    err = maf_compare(torch, rec, name, k.reshape(1, -1), w[None], ["freq"])
    work = {kind: float(torch.stack(v).sum()) for kind, v in tally.items()}
    fc = FLOPS_CELL
    rec.record(name, err, ms, pms,
               2 * cells * g0.element_size() + cells * 4 + sites * 4,
               cells * fc["maf_planes"] + work["pass"] * N
               * fc["maf_pass_fma"] + work["grad"] * N * fc["maf_grad_fma"]
               + work["step"] * fc["maf_window_step_active"])
    f_macro = mk.macro_slab(prep, p_slab)
    if not torch.equal(f_macro, mk._site_vector(k, prep)):
        fail(f"[{rec.label}] macro_slab differs from its kernel")
    d = float((f_macro - mk.est_maf_slab(prep, p_slab)).abs().max())
    log(f"[{rec.label}] {name}: per site {work['pass'] / sites:.2f} real "
        f"passes, {work['grad'] / sites:.2f} gradient evaluations, "
        f"{work['step'] / sites:.1f} window steps; macro_slab against "
        f"est_maf_slab on the same slabs: freq max diff {d:.3g}")
    if d > MAF_FREQ_ATOL:
        fail(f"[{rec.label}] macro_slab off est_maf_slab by {d}")


def product_rule_chain(torch, site, dc, shape, F, alpha, dt):
    """The transfer-and-tangent chain with the product rule written out,
    d(C M) = dC M + C dM, dM/dF and dM/dalpha as full 2x2 matrices (the
    plain version's form before the factored tangents), carried in `dt`
    from the float32 emissions and decay of the package's site function:
    float64 gives the reference the kernel's tangents are held to, float32
    the separate-product plain version the kernel replaced (its bits).
    Each site rescales by a power of two, as the kernel does (a float64
    chain would underflow over a block too). -> ([12, nb, N] in dt, the
    exponent sum [nb, N] int64)."""
    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk

    bs, nb, N = shape
    Fb, ab = F[None, :].to(dt), alpha[None, :]
    one = torch.ones((nb, N), dtype=dt, device=F.device)
    zero = torch.zeros_like(one)
    c, cF, ca = (one, zero, zero, one.clone()), (zero,) * 4, (zero,) * 4
    ex = torch.zeros((nb, N), dtype=torch.int64, device=F.device)
    for r in range(bs):
        e0, e1, x, onem = (v.to(dt) for v in site(r, ab))
        m = hk._site_matrix_plain(e0, e1, x, onem, Fb)
        dxp = torch.where(x > 0.0, dc[r][:, None].to(dt) * x,
                          torch.zeros_like(x))
        oe0, oe1 = onem * e0, onem * e1
        fd, gd = Fb * dxp, (1.0 - Fb) * dxp
        mF = (-oe0, oe1, -oe0, oe1)
        ma = (-fd * e0, fd * e1, gd * e0, -gd * e1)
        n = hk._mm4(c, m)
        nF = tuple(p + q for p, q in zip(hk._mm4(cF, m), hk._mm4(c, mF)))
        na = tuple(p + q for p, q in zip(hk._mm4(ca, m), hk._mm4(c, ma)))
        mx = hk._tiny(hk._max4(*n))
        if dt == torch.float32:
            sc, e = hk._pow2_rescale(mx)
        else:  # the same from the float64 exponent field
            e = (mx.view(torch.int64) >> 52) - 1023
            sc = ((1023 - e) << 52).view(torch.float64)
        c = tuple(v * sc for v in n)
        cF = tuple(v * sc for v in nF)
        ca = tuple(v * sc for v in na)
        ex = ex + e
    return torch.stack(c + cF + ca), ex


def chain_errors(torch, got, ex_got, want, ex_want):
    """(primal, tangent) distance of a chain's 12 rows from the float64
    reference's, both at the reference's exponent: the primal's largest
    absolute difference (its rows are normalised), the tangents' relative
    to each lane's largest entry (at least 1), as the ATOL gate measures
    them."""
    g = got.double() * torch.exp2((ex_got - ex_want).double())
    prim = float((g[:4] - want[:4]).abs().max())
    tang = 0.0
    for lo in (4, 8):
        scale = want[lo:lo + 4].abs().amax(0).clamp_min(1.0)
        tang = max(tang, float(((g[lo:lo + 4] - want[lo:lo + 4]).abs()
                                / scale).max()))
    return prim, tang


def check_tangents_f64(torch, label, name, site, sl, k1, F_t, a_t):
    """The transfer-and-tangent kernel's output k1 against the product
    rule carried in float64 (product_rule_chain), beside the
    separate-product float32 chain's distance from the same reference.
    Fails the run if the kernel's tangents are further than
    TANGENT_F64_ATOL_SITE x bs from it (its primal rows are held to the
    plain version's bits; their distance is printed)."""
    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk

    dc, shape = sl[-1], sl[0].shape
    want, ex_w = product_rule_chain(torch, site, dc, shape, F_t, a_t,
                                    torch.float64)
    ex_k = torch.round(k1[12].double() / hk._LN2).long()
    kp, kt = chain_errors(torch, k1[:12], ex_k, want, ex_w)
    old, ex_o = product_rule_chain(torch, site, dc, shape, F_t, a_t,
                                   torch.float32)
    op, ot = chain_errors(torch, old, ex_o, want, ex_w)
    del want, old
    limit = TANGENT_F64_ATOL_SITE * shape[0]
    log(f"[{label}] {name} against the product rule in float64 (bs "
        f"{shape[0]}): kernel primal {kp:.3g}, tangents {kt:.3g}; the "
        f"separate-product float32 chain primal {op:.3g}, tangents {ot:.3g} "
        f"(limit {limit:.3g})")
    if kt > limit:
        fail(f"{name} [{label}]: tangents {kt} from the float64 product "
             f"rule > {limit}")


def check_streams(torch, dev, rec, timer, label, sl, F_t, a_t, v1):
    """The four stream kernels of one emission source (v1=False: the gl
    slabs of models/hmm_kernels.py, sl = (g0, g2, fc, dc), float32 or
    bfloat16 gl, the latter recorded as the "_bf16" exports; v1=True: the
    emission slabs of models/hmm_kernels_v1.py, sl = (e0, e1, dc)) and the
    combine between them, each against its plain version on `dev`. Fails
    the run on any disagreement; records every kernel (the combine only
    for the float32 gl source). Returns the posterior slab."""
    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
    from ngsf_hmm_tpu_torch.models import hmm_kernels_v1 as h1
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    mod, fn_sfx = (h1, "_v1") if v1 else (hk, "")
    sfx = "_v1" if v1 else cuda_lib.gl_suffix(sl[0], sl[1], label)
    kern = {k: getattr(mod, f"_k_{k}{fn_sfx}") for k in STREAM_KERNELS}
    plain = {k: getattr(mod, f"_{k}{fn_sfx}_plain") for k in STREAM_KERNELS}
    bs, nb, N = sl[0].shape
    cells = bs * nb * N
    slab = cells * 4
    src = 2 * cells * sl[0].element_size()  # the two gl / emission slabs
    record, finite = rec.record, rec.finite

    def flops(k):
        return cells * FLOPS_CELL[k + fn_sfx]

    def common_scale(got, want, off_g, off_w):
        """Both products rescaled to the plain version's exponent: equal
        values whose maxima straddle a power of two normalise apart."""
        return got * torch.exp2(torch.round((off_g - off_w) / hk._LN2)), want

    # ---- transfer + tangents
    k1, ms = timer(lambda: kern["block_transfer_grad"](*sl, F_t, a_t))
    p1, pms = timer(lambda: plain["block_transfer_grad"](*sl, F_t, a_t),
                    reps=1, warm=0)
    finite("block_transfer_grad" + sfx, k1, p1)
    g, w = common_scale(k1[:12], p1[:12], k1[12], p1[12])
    err = float((g[:4] - w[:4]).abs().max())
    for lo in (4, 8):  # tangents, relative to each lane's largest entry
        scale = w[lo:lo + 4].abs().amax(0).clamp_min(1.0)
        err = max(err, float(((g[lo:lo + 4] - w[lo:lo + 4]).abs()
                              / scale).max()))
    if err > ATOL:
        fail(f"block_transfer_grad{sfx} [{label}]: max diff {err} > {ATOL}")
    record("block_transfer_grad" + sfx, err, ms, pms,
           src + 13 * nb * N * 4, flops("block_transfer_grad"))
    del p1
    check_tangents_f64(torch, label, "block_transfer_grad" + sfx,
                       h1._em_site(*sl) if v1 else hk._gl_site(*sl), sl, k1,
                       F_t, a_t)

    # ---- transfer, B = 1 (bit identity with the grad kernel) and B = 2
    F1, a1 = F_t[None].contiguous(), a_t[None].contiguous()
    k4, ms = timer(lambda: kern["block_transfer"](*sl, F1, a1))
    p4, pms = timer(lambda: plain["block_transfer"](*sl, F1, a1),
                    reps=1, warm=0)
    finite("block_transfer" + sfx, k4, p4)
    if dev.type == "cuda":
        prim = torch.cat([k1[0:4], k1[12:13]])
        if not torch.equal(prim, k4[:, 0]):
            fail(f"[{label}] the grad kernel{sfx}'s primal rows are not "
                 "bit-equal to the transfer kernel's output at B = 1")
        log(f"[{label}] grad-kernel{sfx} primal rows torch.equal transfer "
            "kernel (B = 1): True")
    del k1
    g, w = common_scale(k4[:4], p4[:4], k4[4], p4[4])
    err = float((g - w).abs().max())
    F2 = torch.stack([F_t, (F_t * 0.7)]).contiguous()
    a2 = torch.stack([a_t, (a_t * 1.5)]).contiguous()
    kb, pb = (kern["block_transfer"](*sl, F2, a2),
              plain["block_transfer"](*sl, F2, a2))
    g, w = common_scale(kb[:4], pb[:4], kb[4], pb[4])
    err = max(err, float((g - w).abs().max()))
    if not torch.equal(kb[:, 0], k4[:, 0]) and dev.type == "cuda":
        fail(f"[{label}] block_transfer{sfx}: candidate 0 of B = 2 differs "
             "from B = 1")
    if err > ATOL:
        fail(f"block_transfer{sfx} [{label}]: max diff {err} > {ATOL}")
    record("block_transfer" + sfx, err, ms, pms, src + 5 * nb * N * 4,
           flops("block_transfer"))
    del pb, p4

    # ---- cross-block combine (two levels: chunks of L blocks)
    A_r = k4.permute(2, 0, 1, 3)
    (st_k, en_k, ll_k), ms = timer(lambda: hk._combine_blocks(A_r, F1))
    (st_p, en_p, ll_p), pms = timer(
        lambda: hk._combine_blocks_plain(A_r, F1), reps=1, warm=0)
    finite("combine_blocks", st_k, en_k, ll_k)
    norm = lambda v: v / v.sum(1, keepdim=True)
    err = max(float((norm(st_k) - norm(st_p)).abs().max()),
              float((norm(en_k) - norm(en_p)).abs().max()))
    ll_err = float(((ll_k - ll_p).abs() / ll_p.abs()).max())
    fwbw = float((ll_k[0] - ll_k[1]).abs().max())
    same = all(torch.equal(a, b) for a, b in
               zip((st_k, en_k, ll_k), (st_p, en_p, ll_p)))
    # candidate 0 of B = 2 (the transfer kernel's B = 2 products) against
    # B = 1, and a second call on the same bits
    two = hk._combine_blocks(kb.permute(2, 0, 1, 3), F2)
    b_same = all(torch.equal(a[..., :1, :], b)
                 for a, b in zip(two, (st_k, en_k, ll_k)))
    again = all(torch.equal(a, b) for a, b in
                zip(hk._combine_blocks(A_r, F1), (st_k, en_k, ll_k)))
    L = hk.combine_chunk_len(nb)
    log(f"[{label}] combine_blocks (nb={nb}, chunks of L={L}: "
        f"{-(-nb // L)}): kernel {ms:.4f} ms, bit-equal to the plain "
        f"version {same}, candidate 0 of B = 2 equal to B = 1 {b_same}, "
        f"repeat equal {again}; loglik rel diff {ll_err:.3g}, "
        f"|ll_f - ll_b| max {fwbw:.3g}")
    if err > ATOL or ll_err > LL_RTOL or fwbw > 1e-3:
        fail(f"combine_blocks [{label}]: vectors {err}, logliks {ll_err}, "
             f"fw/bw {fwbw}")
    if dev.type == "cuda" and not (same and b_same and again):
        fail(f"combine_blocks [{label}]: not bit-equal (plain {same}, "
             f"B = 2 {b_same}, repeat {again})")
    if not sfx:
        record("combine_blocks", err, ms, pms,
               (5 + 4) * nb * N * 4 + 2 * N * 8, 2 * nb * N * 12)
    rec.results.setdefault("combine_blocks", {"max_abs_err": 0.0}).setdefault(
        "ms_by_shape", {})[f"{label} nb={nb} N={N}"] = ms
    del k4, kb, A_r, two

    # ---- backward ratio slab
    ends = en_k[:, :, 0].transpose(0, 1).contiguous()
    bw_k, ms = timer(lambda: kern["bw_sites"](*sl, F_t, a_t, ends))
    bw_p, pms = timer(lambda: plain["bw_sites"](*sl, F_t, a_t, ends),
                      reps=1, warm=0)
    finite("bw_sites" + sfx, bw_k, bw_p)
    err = float((bw_k - bw_p).abs().max())
    if err > ATOL:
        fail(f"bw_sites{sfx} [{label}]: max diff {err} > {ATOL}")
    record("bw_sites" + sfx, err, ms, pms, src + slab + 2 * nb * N * 4,
           flops("bw_sites"))
    del bw_p

    # ---- posterior slab
    starts = st_k[:, :, 0].transpose(0, 1).contiguous()
    po_k, ms = timer(lambda: kern["fw_post"](*sl, F_t, a_t, starts, bw_k))
    po_p, pms = timer(lambda: plain["fw_post"](*sl, F_t, a_t, starts, bw_k),
                      reps=1, warm=0)
    finite("fw_post" + sfx, po_k, po_p)
    err = float((po_k - po_p).abs().max())
    if err > ATOL:
        fail(f"fw_post{sfx} [{label}]: max diff {err} > {ATOL}")
    if not bool(((po_k >= 0) & (po_k <= 1)).all()):
        fail(f"fw_post{sfx} [{label}]: posterior outside [0, 1]")
    record("fw_post" + sfx, err, ms, pms, src + 2 * slab + 2 * nb * N * 4,
           flops("fw_post"))
    n_one = int((po_k == 1.0).sum())
    log(f"[{label}] posterior slab{sfx}: {n_one} cells exactly 1.0 "
        "(the het floor's case)")
    return po_k


def offset_view(torch, t, k=1):
    """A copy of t in a contiguous view that starts k elements into its
    storage (a slab cut from a larger buffer)."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    v = buf[k:].view(t.shape)
    v.copy_(t)
    return v


def check_offset_slabs(torch, label, kern, sl, F_t, a_t):
    """The transfer-and-tangent kernel on slabs that start one element
    into their storage (4-byte aligned float32, 2-byte aligned bfloat16
    base addresses: the copy width must follow them, not the row length
    alone) equals its output on the aligned slabs bit for bit."""
    want = kern(*sl, F_t, a_t)
    got = kern(offset_view(torch, sl[0]), offset_view(torch, sl[1]),
               *sl[2:], F_t, a_t)
    if not torch.equal(got, want):
        fail(f"[{label}] the transfer-and-tangent kernel on offset slabs "
             "differs from its output on aligned ones")
    log(f"[{label}] transfer-and-tangent kernel on slabs one element into "
        "their storage torch.equal the aligned ones: True")


def check_copy_widths(torch, dev, seed, S=3001):
    """The stream kernels of all three sources at S sites x 33 and 34
    columns: lanes odd and lanes = 2 mod 4, so the transfer-and-tangent
    kernel stages its rows with every copy width (16 and 8 bytes at the
    main and restart shapes; 8 and 4 bytes here for float32 rows, 4 and 2
    for bfloat16 ones), with a partial last tile. Each kernel against its
    plain version (check_streams, the primal rows' bit identity included);
    then the transfer-and-tangent kernel on slabs whose base addresses are
    not aligned to the row's width (check_offset_slabs). Nothing is
    recorded."""
    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
    from ngsf_hmm_tpu_torch.models import hmm_kernels_v1 as h1
    from ngsf_hmm_tpu_torch.ops.emissions import calc_emission

    f32 = torch.float32
    timer = Timer(torch, dev)
    for N in (33, 34):
        gl, dist, freq, F, alpha = simulate(S, N, seed + N, n_chrom=2)
        gl_t = torch.as_tensor(gl).to(dev, f32)
        dist_t = torch.as_tensor(dist).to(dev, f32)
        freq_t = torch.as_tensor(freq).to(dev, f32)
        F_t = torch.as_tensor(F).to(dev, f32)
        a_t = torch.as_tensor(alpha).to(dev, f32)
        for dt in (f32, torch.bfloat16):
            prep = hk.prepare_gl_inputs(torch.exp(gl_t), dist_t, gl_dtype=dt)
            label = f"copy widths N={N} lanes={prep['nb'] * N} {dt}"
            sl = (prep["g0"], prep["g2"], hk.freq_compact(freq_t, prep),
                  prep["dc"])
            check_streams(torch, dev, Recorder(torch, label, {}), timer,
                          label, sl, F_t, a_t, False)
            check_offset_slabs(torch, label, hk._k_block_transfer_grad, sl,
                               F_t, a_t)
        prep = h1.prepare_inputs(calc_emission(gl_t, freq_t[:, None]), dist_t)
        label = f"copy widths N={N} v1"
        sl = (prep["e0"], prep["e1"], prep["dc"])
        check_streams(torch, dev, Recorder(torch, label, {}), timer, label,
                      sl, F_t, a_t, True)
        check_offset_slabs(torch, label, h1._k_block_transfer_grad_v1, sl,
                           F_t, a_t)


def check_v1_kernels(torch, dev, e_prob, dist, F, alpha, label, results,
                     probe=False):
    """The emission-slab kernels (models/hmm_kernels_v1.py) against their
    plain versions on `dev`: e_prob [S, L, 2] log emissions, F / alpha [L]
    (L columns: individuals, or replicate x individual). Also holds the
    public posteriors_v1 / loglik_value_and_grad_v1 to the pieces.
    probe: also probe_transfer on these slabs."""
    from ngsf_hmm_tpu_torch.models import hmm_kernels_v1 as h1

    f32 = torch.float32
    S, L = e_prob.shape[0], e_prob.shape[1]
    prep = h1.prepare_inputs(e_prob, torch.as_tensor(dist).to(dev, f32))
    F_t = torch.as_tensor(F).to(dev, f32).contiguous()
    a_t = torch.as_tensor(alpha).to(dev, f32).contiguous()
    bs, nb = prep["bs"], prep["nb"]
    log(f"[{label}] S={S} columns={L} bs={bs} nb={nb} lanes={nb * L} "
        f"pad sites={nb * bs - S} breaks={int(np.isinf(dist).sum())}")
    rec = Recorder(torch, label, results)
    sl = (prep["e0"], prep["e1"], prep["dc"])
    po_k = check_streams(torch, dev, rec, Timer(torch, dev), label, sl, F_t,
                         a_t, v1=True)
    if probe and dev.type == "cuda":
        probe_transfer(torch, Timer(torch, dev), label, sl, F_t, a_t, True)
    p, _, _, slab = h1.posteriors_v1(F_t, a_t, prep, return_slab=True)
    if not torch.equal(slab, po_k):
        fail(f"[{label}] posteriors_v1 differs from its kernels")
    ll, gF, ga = h1.loglik_value_and_grad_v1(F_t, a_t, prep)
    rec.finite("loglik_value_and_grad_v1", ll, gF, ga)
    d = float(((ll - h1.forward_loglik_v1(F_t[None], a_t[None], prep)[0])
               .abs() / ll.abs()).max())
    log(f"[{label}] loglik_value_and_grad_v1 against forward_loglik_v1: "
        f"rel diff {d:.3g}")
    if d > LL_RTOL:
        fail(f"[{label}] the v1 value and the v1 forward loglik differ by {d}")


def check_kernels(torch, dev, gl, dist, freq, F, alpha, label, results,
                  reference=False, probes=False, bf16=False):
    """Every kernel's wrapper against its plain version on `dev` at this
    shape; fills results[name] with the error and times. Fails the run on
    any disagreement. reference=True also holds the est_maf functions
    against ops/maf.est_maf on the unpacked [S, N] arrays. bf16=True also
    holds the one-launch slab est_maf on these slabs, then the bfloat16
    exports of the gl kernels on bfloat16 slabs of the same gl. probes
    (on the card): also probe_transfer on both slab types and
    probe_fmad."""
    from ngsf_hmm_tpu_torch.models import hmm as thmm
    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
    from ngsf_hmm_tpu_torch.ops.emissions import calc_emission

    timer = Timer(torch, dev)
    f32 = torch.float32
    S, N = gl.shape[0], gl.shape[1]
    gl_t = torch.as_tensor(gl).to(dev, f32)
    dist_t = torch.as_tensor(dist).to(dev, f32)
    freq_t = torch.as_tensor(freq).to(dev, f32)
    F_t = torch.as_tensor(F).to(dev, f32)
    a_t = torch.as_tensor(alpha).to(dev, f32)
    prep = hk.prepare_gl_inputs(torch.exp(gl_t), dist_t)
    fc = hk.freq_compact(freq_t, prep)
    bs, nb = prep["bs"], prep["nb"]
    log(f"[{label}] S={S} N={N} bs={bs} nb={nb} lanes={nb * N} "
        f"pad sites={nb * bs - S} breaks={int(np.isinf(dist).sum())}")
    sl = (prep["g0"], prep["g2"], fc, prep["dc"])
    rec = Recorder(torch, label, results)
    record, finite = rec.record, rec.finite

    po_k = check_streams(torch, dev, rec, timer, label, sl, F_t, a_t,
                         v1=False)
    if probes and dev.type == "cuda":
        probe_transfer(torch, timer, label, sl, F_t, a_t, False)
    p_sites = hk._unpack_sites2(po_k, prep)
    del sl

    # ---- the est_maf kernels, on the slabs and the posterior from above
    ref = dict(p_sites=p_sites, gl_lin=torch.exp(gl_t)) if reference else {}
    check_maf_kernels(torch, dev, prep, po_k, rec, timer, **ref)
    if probes and dev.type == "cuda":
        probe_fmad(torch, prep, po_k, timer, label)
    if bf16:
        check_macro_slab(torch, prep, po_k, rec, timer)
        prep_b = hk.prepare_gl_inputs(torch.exp(gl_t), dist_t,
                                      gl_dtype=torch.bfloat16)
        rec_b = Recorder(torch, f"{label} bf16", results)
        sl_b = (prep_b["g0"], prep_b["g2"], fc, prep_b["dc"])
        po_b = check_streams(torch, dev, rec_b, timer, rec_b.label, sl_b,
                             F_t, a_t, v1=False)
        if probes and dev.type == "cuda":
            probe_transfer(torch, timer, rec_b.label, sl_b, F_t, a_t, False)
        del sl_b
        log(f"[{rec_b.label}] posterior slab against the float32 slabs' "
            f"one: max diff {float((po_b - po_k).abs().max()):.3g} (the gl "
            "quantisation; information)")
        check_maf_kernels(torch, dev, prep_b, po_b, rec_b, timer)
        check_macro_slab(torch, prep_b, po_b, rec_b, timer)
        del prep_b, po_b
    del po_k, p_sites, prep, ref

    # ---- Viterbi (float32, the main path's dtype; both variants)
    e_prob = calc_emission(gl_t, freq_t[:, None])
    err = 0.0
    for compat in (True, False):
        (pk, sk), ms_c = timer(
            lambda: thmm.viterbi(e_prob, dist_t, F_t, a_t, compat=compat),
            reps=1)
        (pp, sp), pms_c = timer(
            lambda: thmm._viterbi_plain(e_prob, dist_t, F_t, a_t, compat,
                                        None, None), reps=1, warm=0)
        finite("viterbi", sk, sp)
        mism = int((pk != pp).sum())
        s_err = float(((sk - sp).abs() / sp.abs()).max())
        floor = chain_floor_ms(S, compat)
        bare = ""
        if dev.type == "cuda":
            b_ms = probe_chain(torch, timer, S, N, compat)
            bare = (f"; the chain alone from registers {b_ms:.3f} ms "
                    f"({b_ms * 1e3 * SM_CLOCK_MHZ / (-(-S // 16) * 16):.1f} "
                    f"cycles a site at "
                    f"{SM_CLOCK_MHZ:.0f} MHz, measured)")
        log(f"[{label}] viterbi compat={compat}: path mismatches {mism}, "
            f"score rel diff {s_err:.3g}, IBD share "
            f"{float(pk.float().mean()):.4f}; kernel {ms_c:.3f} ms against "
            f"a derived chain floor of {floor:.3f} ms ({S} sites x "
            f"{CHAIN_CYCLES[compat]} cycles at {SM_CLOCK_MHZ:.0f} MHz){bare}")
        if mism or s_err > LL_RTOL:
            fail(f"viterbi [{label}] compat={compat}: {mism} path cells "
                 f"differ, score rel diff {s_err}")
        if compat:
            ms, pms = ms_c, pms_c
        err = max(err, s_err)
        if S > 500_000:
            break  # the per-site plain loop is minutes at this size
    # bytes the function must move: the log emissions and distances in,
    # the int8 path out (its back-pointer scratch is the kernel's own)
    record("viterbi", err, ms, pms, S * N * (8 + 1) + S * 4 + N * 12,
           S * N * 40)


def check_viterbi_hooks(torch, dev, S, N, seed):
    """Viterbi against its plain version at S sites with chromosome breaks
    (S not a multiple of the traceback blocks below): both variants, the
    stationary init and forced (init_logits, final_state), traceback
    blocks of the default length, 1 site and 77 sites. Zero path
    mismatches, scores bit-equal. N sets how many individuals share a CTA
    of the forward kernel (1 up to 132 on a 132-SM card, 32 from 2,113)."""
    from ngsf_hmm_tpu_torch.models import hmm as thmm
    from ngsf_hmm_tpu_torch.ops.emissions import calc_emission

    f32 = torch.float32
    gl, dist, freq, F, alpha = simulate(S, N, seed, n_chrom=3)
    e_prob = calc_emission(torch.as_tensor(gl).to(dev, f32),
                           torch.as_tensor(freq).to(dev, f32)[:, None])
    dist_t = torch.as_tensor(dist).to(dev, f32)
    F_t = torch.as_tensor(F).to(dev, f32)
    a_t = torch.as_tensor(alpha).to(dev, f32)
    rng = np.random.default_rng(seed)
    il = torch.as_tensor(np.log(rng.dirichlet(np.ones(2), size=N))).to(
        dev, f32)
    fs = torch.as_tensor(rng.integers(0, 2, size=N)).to(dev, torch.int8)
    label = f"viterbi S={S} N={N}"
    Ls = (thmm.VITERBI_BLOCK, 1, 77)
    if any(S % L == 0 for L in Ls[::2]):
        fail(f"[{label}] S is a multiple of a traceback block")
    for compat in (True, False):
        for hooks in (dict(init_logits=None, final_state=None),
                      dict(init_logits=il, final_state=fs)):
            pp, sp = thmm._viterbi_plain(e_prob, dist_t, F_t, a_t, compat,
                                         **hooks)
            for L in Ls:
                pk, sk = thmm.viterbi(e_prob, dist_t, F_t, a_t,
                                      compat=compat, L=L, **hooks)
                mism = int((pk != pp).sum())
                forced = hooks["final_state"] is not None
                if mism or not torch.equal(sk, sp) or (
                        forced and not torch.equal(pk[-1], fs)):
                    fail(f"[{label}] compat={compat} hooks={forced} L={L}: "
                         f"{mism} path cells differ, scores equal "
                         f"{torch.equal(sk, sp)}")
            log(f"[{label}] compat={compat} init/final forced="
                f"{hooks['final_state'] is not None}: paths equal to the "
                f"plain version at traceback blocks {Ls}, scores "
                f"bit-equal, breaks {int(np.isinf(dist).sum())}")


class MafTimer:
    """While active, times every freq M-step of em_iteration (the three
    est_maf entry points of ops/maf_kernels; or the functions `names` of
    module `mod`) with CUDA events; `ms()` gives one time per call."""

    NAMES = ("est_maf_slab", "est_maf_exact", "est_maf_rows")

    def __init__(self, torch, dev, mod=None, names=None):
        if mod is None:
            from ngsf_hmm_tpu_torch.ops import maf_kernels as mod
        self.torch, self.cuda, self.mod = torch, dev.type == "cuda", mod
        self.names = names or self.NAMES
        self.spans = []

    def __enter__(self):
        self.saved = {n: getattr(self.mod, n) for n in self.names}
        for name, fn in self.saved.items():
            setattr(self.mod, name, self._timed(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)

    def _timed(self, fn):
        def wrapper(*a, **kw):
            if not self.cuda:
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.spans.append((time.perf_counter() - t0) * 1e3)
                return out
            ev = [self.torch.cuda.Event(enable_timing=True) for _ in "ab"]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            self.spans.append(ev)
            return out
        return wrapper

    def ms(self):
        if self.cuda:
            self.torch.cuda.synchronize()
        return [sp if isinstance(sp, float) else sp[0].elapsed_time(sp[1])
                for sp in self.spans]


def reset_peak(torch, dev, label):
    """Frees what is collectable and resets the peak memory counter just
    before a path; logs what is still allocated then (the tensors of
    earlier phases a path's peak would include)."""
    import gc

    if dev.type != "cuda":
        return
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"[{label}] allocated at the peak reset "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")


def peak_gib(torch, dev, reset=False):
    """The peak allocated device memory since the last reset, in GiB;
    reset=True then starts a new span (what is allocated stays counted)."""
    if dev.type != "cuda":
        return float("nan")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return peak


def slab_est_maf_step(torch, dev, label, gl, dist, st, gl_bf16):
    """At a path's end: one posterior slab at the final parameters on the
    path's kind of gl slabs, then est_maf_slab and macro_slab (the
    one-launch slab kernel) on it, each timed; fails unless their freqs
    agree within MAF_FREQ_ATOL."""
    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk

    f32 = torch.float32
    prep = hk.prepare_gl_inputs(
        torch.exp(torch.as_tensor(gl).to(dev, f32)),
        torch.as_tensor(dist).to(dev, f32),
        gl_dtype=torch.bfloat16 if gl_bf16 else f32)
    _, _, _, p_slab = hk.posteriors_fused(
        st.indF, st.alpha, prep, hk.freq_compact(st.freq, prep),
        return_slab=True, return_p=False)
    timer = Timer(torch, dev)
    f_slab, ms_slab = timer(lambda: mk.est_maf_slab(prep, p_slab))
    f_macro, ms_macro = timer(lambda: mk.macro_slab(prep, p_slab))
    d = float((f_macro - f_slab).abs().max())
    log(f"[{label}] at the final parameters: est_maf_slab {ms_slab:.3f} ms, "
        f"macro_slab (one launch) {ms_macro:.3f} ms, freq max diff {d:.3g}")
    if d > MAF_FREQ_ATOL:
        fail(f"[{label}] macro_slab off est_maf_slab by {d}")


def run_path(torch, dev, label, gl, dist, freq_true, indF0, alpha0, freq_est,
             need, writers, gl_bf16=False, against=None):
    """init_state -> run_em [-> writers] with the launch counts set to 0
    just before and read just after; fails unless every kernel in `need`
    was launched, no plain version was called and what came out is sound.
    gl_bf16: the run's gl slabs in bfloat16 (EMOptions.gl_bf16); no
    float32 gl-slab kernel may launch then. Under freq_est 1 with a macro
    schedule (N >= 32) the path ends with slab_est_maf_step. against: the
    (freq, ind_lkl) of a float32 run of the same data, held at the bf16
    envelopes. Returns (the launch counts, (freq, ind_lkl) of the final
    state)."""
    from ngsf_hmm_tpu_torch.io.writers import write_geno, write_ibd, write_indF
    from ngsf_hmm_tpu_torch.models.em import (EMOptions, init_state,
                                              rebuild_eprob, run_em)
    from ngsf_hmm_tpu_torch.ops.maf import macro_schedule
    from ngsf_hmm_tpu_torch.utils import cuda_lib
    from ngsf_hmm_tpu_torch.utils.constants import (ALPHA_MAX, ALPHA_MIN,
                                                    F_MAX, F_MIN)

    S, N = gl.shape[0], gl.shape[1]
    opts = EMOptions(freq_est=freq_est, min_iters=3, max_iters=4, verbose=0,
                     gl_bf16=gl_bf16)
    # fixed frequencies are the simulated ones; estimated ones start flat
    freq0 = freq_true if freq_est == 0 else np.full(S, 0.2)
    iters = []

    def trace(event, **kw):
        if event == "iter_done":
            if dev.type == "cuda":
                torch.cuda.synchronize()
            iters.append((kw["dt"], kw["tot_lkl"], cuda_lib.LAUNCHES[
                "block_transfer_grad" + ("_bf16" if gl_bf16 else "")]))

    reset_peak(torch, dev, label)
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    state = init_state(gl, freq0, indF0, alpha0, device=dev)
    e_prob0 = state.e_prob[:1000].clone()
    peak_init = peak_gib(torch, dev, reset=True)
    with MafTimer(torch, dev) as maf_timer:
        res = run_em(gl, dist, state, opts, trace=trace, device=dev)
    del state
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_em = time.perf_counter() - t0
    peak = peak_gib(torch, dev)
    st = res.state
    if freq_est and macro_schedule(N) is not None:
        slab_est_maf_step(torch, dev, label, gl, dist, st, gl_bf16)
    to_np = lambda t: t.detach().cpu().numpy()
    sizes = {}
    if writers:
        # the outputs (3.4 GB at full size) go under the checkout's build
        # directory, one file at a time
        scratch = cuda_lib.build_dir()
        scratch.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=scratch) as tmp:
            out = os.path.join(tmp, "smoke")
            for ext, write in (
                ("indF", lambda f: write_indF(
                    f, res.tot_lkl, to_np(st.indF), to_np(st.alpha),
                    to_np(st.freq))),
                ("ibd", lambda f: write_ibd(
                    f, to_np(st.ind_lkl), res.path, to_np(st.p_ibd))),
                ("geno", lambda f: write_geno(
                    f, gl.astype(np.float64),
                    to_np(st.freq).astype(np.float64), res.path)),
            ):
                write(f"{out}.{ext}")
                sizes[ext] = os.path.getsize(f"{out}.{ext}")
                os.remove(f"{out}.{ext}")
    counts = dict(cuda_lib.LAUNCHES)
    plain = dict(cuda_lib.PLAIN_CALLS)
    t_all = time.perf_counter() - t0

    # ---- what came out
    if dev.type == "cuda":
        if plain:
            fail(f"[{label}] the path called plain versions: {plain}")
        missing = [k for k in need if counts.get(k, 0) < 1]
        if missing:
            fail(f"[{label}] never launched: {missing} (counts {counts})")
        f32_gl = [k for k in GL_KERNELS if gl_bf16 and counts.get(k, 0)]
        if f32_gl:
            fail(f"[{label}] float32 gl-slab kernels launched: {f32_gl}")
    elif not plain:
        fail("rehearsal: no plain version was called")
    if not (opts.min_iters <= res.n_iters <= opts.max_iters
            and len(iters) == res.n_iters):
        fail(f"[{label}] expected 3 or 4 EM iterations, ran {res.n_iters}")
    h = res.lkl_history
    if not np.all(np.isfinite(h)):
        fail(f"[{label}] non-finite total log-likelihood: {h}")
    # With freq frozen EM is monotone; the optimizer only accepts float32
    # decreases of each individual's objective, and the float32 ind_lkl
    # round at |ll| ~ S: slack = N ulps of float32 at that magnitude. With
    # freq estimated, monotonicity is only approximate: est_maf is the
    # reference's damped fixed point cut at ITER_MAX + 1 passes (emulated
    # by linearised windows on the macro tier), not the maximiser of the
    # expected log-likelihood, so a late step can lose a little (3.5e-5 of
    # |ll| seen at 2,003 x 33 on the CPU). There the gate is: the run ends
    # above its start and no step loses more than 1e-4 of |ll|.
    slack = N * float(np.spacing(np.float32(abs(h[0]) / N)))
    if freq_est:
        slack = 1e-4 * abs(h[0])
        if not h[-1] > h[0]:
            fail(f"[{label}] total log-likelihood did not improve: {h}")
    if any(b < a - slack for a, b in zip(h, h[1:])):
        fail(f"[{label}] total log-likelihood decreased beyond {slack}: {h}")
    indF, alpha, freq = to_np(st.indF), to_np(st.alpha), to_np(st.freq)
    f32 = np.float32
    if not (np.all(indF >= f32(F_MIN)) and np.all(indF <= f32(F_MAX))
            and np.all(alpha >= f32(ALPHA_MIN))
            and np.all(alpha <= f32(ALPHA_MAX))):
        fail(f"[{label}] indF / alpha outside their boxes")
    p_ibd = to_np(st.p_ibd)
    if p_ibd.shape != (S, N) or not np.all((p_ibd >= 0) & (p_ibd <= 1)):
        fail(f"[{label}] p_ibd not in [0, 1] or of the wrong shape")
    if res.path.shape != (S, N) or not np.isin(res.path, (0, 1)).all():
        fail(f"[{label}] Viterbi path not in {{0, 1}} or of the wrong shape")
    # freq: [S] with no pad (the slabs' pad sentinel is 2.0), inside [0, 1]
    if freq.shape != (S,) or not np.all(np.isfinite(freq)) or not np.all(
            (freq >= 0) & (freq <= 1)):
        fail(f"[{label}] freq not finite in [0, 1] or of the wrong shape")
    e_head = st.e_prob[:1000]
    if freq_est == 0:
        if not np.array_equal(freq, freq0.astype(f32)) or not torch.equal(
                e_head, e_prob0):
            fail(f"[{label}] freq or e_prob moved under freq_est 0")
    else:
        f_err = float(np.abs(freq - freq_true).mean())
        corr = float(np.corrcoef(freq, freq_true)[0, 1])
        log(f"[{label}] freq: moved from 0.2 by mean "
            f"{np.abs(freq - 0.2).mean():.4f}, mean |freq - simulated| "
            f"{f_err:.4f}, correlation with the simulated {corr:.3f}")
        # a sanity band, not a precision claim: the likelihoods are noisy
        # (the true genotype is favoured about 6 : 1) and the damped
        # fixed point stops at ITER_MAX + 1 passes
        if f_err > 0.2 or corr < 0.3:
            fail(f"[{label}] estimated freq unrelated to the simulated one")
        want = rebuild_eprob(torch.as_tensor(gl[:1000]).to(dev),
                             st.freq[:1000])
        if torch.equal(e_head, e_prob0) or not torch.equal(e_head, want):
            fail(f"[{label}] e_prob was not rebuilt from the final freq")
        maf_ms = maf_timer.ms()
        if len(maf_ms) != res.n_iters:
            fail(f"[{label}] {len(maf_ms)} freq M-steps in {res.n_iters} "
                 "iterations")
    finals = (freq, to_np(st.ind_lkl))
    FINAL_FREQ[label] = freq
    if against is not None:
        d_freq = float(np.abs(freq - against[0]).max())
        d_ll = float((np.abs(finals[1] - against[1])
                      / np.abs(against[1])).max())
        log(f"[{label}] against the float32 run: freq max diff {d_freq:.3g} "
            f"(envelope {BF16_FREQ_ATOL}), ind_lkl max rel diff {d_ll:.3g} "
            f"(envelope {BF16_LL_RTOL})")
        if d_freq > BF16_FREQ_ATOL or d_ll > BF16_LL_RTOL:
            fail(f"[{label}] outside the bf16 envelopes: freq {d_freq}, "
                 f"ind_lkl {d_ll}")
    if writers:
        if sizes["geno"] != S * N * 3 * 8:
            fail(f".geno holds {sizes['geno']} bytes, expected {S * N * 24}")
        if sizes["ibd"] < N * (S + 1) + N * S * 9 or sizes["indF"] < S * 9:
            fail(f"output files too small: {sizes}")
    probes = np.diff([0] + [c for _, _, c in iters])
    log(f"[{label}] S={S} N={N} float32, gl slabs "
        f"{'bfloat16' if gl_bf16 else 'float32'}, freq_est {freq_est}: init + "
        f"{res.n_iters} EM iterations + Viterbi in {t_em:.2f} s"
        + (f", with writers {t_all:.2f} s" if writers else ""))
    for i, ((dt, tot, _), n_str) in enumerate(zip(iters, probes), 1):
        log(f"[{label}] iteration {i}: {dt:.3f} s, tot_lkl {tot:.3f}, "
            f"transfer+tangent streams {n_str} (E-step 1 + L-BFGS probes "
            f"{n_str - 1}), L-BFGS outer iterations {res.opt_iters[i - 1]}"
            + (f", freq M-step {maf_ms[i - 1]:.3f} ms" if freq_est else ""))
    log(f"[{label}] mean indF {indF.mean():.4f}, mean alpha "
        f"{alpha.mean():.4f}, Viterbi IBD share {res.path.mean():.4f}, mean "
        f"p_ibd {p_ibd.mean():.4f}")
    SUMMARY[label] = dict(streams=[int(n) for n in probes],
                          tot_lkl=float(iters[-1][1]),
                          ibd=f"{res.path.mean():.4f}")
    if dev.type == "cuda":
        log(f"[{label}] peak torch.cuda.max_memory_allocated "
            f"{max(peak_init, peak):.2f} GiB: init_state {peak_init:.2f} GiB, "
            f"run_em {peak:.2f} GiB")
    log(f"[{label}] launches {counts}; output bytes {sizes}")
    return counts, finals


# per path: L-BFGS streams per iteration, final tot_lkl, Viterbi IBD share
SUMMARY = {}
# per path: the final freq [S]
FINAL_FREQ = {}


def against_parent(path, label="main"):
    """Holds this run's `label` path to another tree's chip_smoke.py log at
    `path` (the same data from the same seed): the same transfer+tangent
    streams per iteration, the final tot_lkl within 1e-6 relative, the
    same Viterbi IBD share to four digits."""
    import re

    streams, tot, ibd = [], None, None
    for line in open(path):
        m = re.match(rf"\[{label}\] iteration \d+: .*tot_lkl (\S+), "
                     r"transfer\+tangent streams (\d+)", line)
        if m:
            tot, streams = float(m.group(1)), streams + [int(m.group(2))]
        m = re.match(rf"\[{label}\] mean indF .*Viterbi IBD share (\S+),",
                     line)
        if m:
            ibd = m.group(1)
    mine = SUMMARY[label]
    if tot is None or ibd is None:
        fail(f"[{label}] no iteration or IBD line in {path}")
    rel = abs(mine["tot_lkl"] - tot) / abs(tot)
    log(f"[{label}] against {path}: streams per iteration {mine['streams']} "
        f"(there {streams}), final tot_lkl {mine['tot_lkl']:.3f} (there "
        f"{tot:.3f}, relative difference {rel:.3g}), Viterbi IBD share "
        f"{mine['ibd']} (there {ibd})")
    if mine["streams"] != streams or rel > 1e-6 or mine["ibd"] != ibd:
        fail(f"[{label}] differs from {path}")


def run_maf_anchor(torch, dev, args):
    """--maf-anchor OUT: the float64 anchor of the one-launch est_maf
    functions (est_maf_exact at the exact path's shape, macro_slab at the
    main path's, est_maf_rows on the LD path's rows), then the exact and
    ld paths, on this tree's package or on --tree's; writes the anchor's
    readings (anchor.json) and the two paths' final freqs
    ({exact,ld}_freq.npy) under OUT for --against-maf. Prints no result
    and returns 4."""
    import pathlib

    out = pathlib.Path(args.maf_anchor)
    out.mkdir(parents=True, exist_ok=True)
    (gl_x, dist_x, freq_x, F0_x, a0_x), gl_t, prep, p_sites, p_slab = (
        exact_shape_inputs(torch, dev, args.check_sites, 20, args.seed + 11))
    anchor_exact(torch, "exact shape N=20", gl_t, prep, p_sites, p_slab)
    del gl_t, prep, p_sites, p_slab
    gl, dist, freq, F0, a0 = simulate(args.sites, args.ind, args.seed)
    rows, p_m, prep, _, p_raw, slab_raw = maf_rows_inputs(
        torch, dev, gl, dist, freq, F0, a0, raw=True)
    anchor_macro(torch, rows, p_m, prep, p_raw, slab_raw)
    del rows, p_m, prep, p_raw, slab_raw
    run_path(torch, dev, "exact", gl_x, dist_x, freq_x, F0_x, a0_x, 1,
             CHAIN_KERNELS + ("maf_exact",), writers=False)
    run_ld_path(torch, dev, "ld", gl, dist, freq, F0, a0, 1)
    (out / "anchor.json").write_text(json.dumps(ANCHORS, indent=1))
    for label in ("exact", "ld"):
        np.save(out / f"{label}_freq.npy", FINAL_FREQ[label])
    log(f"maf anchor written to {out}; no result is printed for it")
    return 4


def against_maf(path):
    """Sets this run's float64 anchor beside another tree's and holds the
    exact and ld paths' final freqs to that tree's (run_maf_anchor's
    files under `path`, the same data from the same seed): prints whether
    each function's largest and mean distance from float64 and its share
    of sites off by a step are no larger than there (information); fails
    unless the final freqs are within MAF_FREQ_ATOL of there."""
    import pathlib

    path = pathlib.Path(path)
    there = json.loads((path / "anchor.json").read_text())
    for key, r in there.items():
        mine = ANCHORS.get(key)
        if mine is None:
            fail(f"{key}: no float64 anchor in this run")
        closer = {k: mine[k] <= r[k] for k in ("max", "mean", "share")}
        log(f"{key} against {path}: from float64 max {mine['max']:.4g} "
            f"(there {r['max']:.4g}), mean {mine['mean']:.4g} (there "
            f"{r['mean']:.4g}), sites off {mine['share']:.4g} (there "
            f"{r['share']:.4g}); no further than there: {closer}")
    for label in ("exact", "ld"):
        d = float(np.abs(FINAL_FREQ[label]
                         - np.load(path / f"{label}_freq.npy")).max())
        log(f"[{label}] final freq against {path}: max diff {d:.3g}")
        if d > MAF_FREQ_ATOL:
            fail(f"[{label}] final freq off {path}'s by {d}")


def run_restart_path(torch, dev, gl, dist, freq_true, R, seed):
    """stack_restart_states -> run_em_restarts (R lockstep replicates
    flattened into the columns, freq_est 1, min_iters 3, max_iters 4,
    best-replicate Viterbi; no writers) with the launch counts set to 0
    just before and read just after; fails unless every kernel of the
    route was launched, no plain version was called and what came out is
    sound. Returns the launch counts."""
    from ngsf_hmm_tpu_torch.models.em import EMOptions, rebuild_eprob
    from ngsf_hmm_tpu_torch.models.restart import (run_em_restarts,
                                                   stack_restart_states)
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    label = "restart"
    S, N = gl.shape[0], gl.shape[1]
    opts = EMOptions(freq_est=1, min_iters=3, max_iters=4, verbose=0)
    iters = []

    def trace(event, **kw):
        if event == "iter_done":
            if dev.type == "cuda":
                torch.cuda.synchronize()
            iters.append((kw["dt"], kw["tot_lkl"].copy(), kw["active"].copy(),
                          cuda_lib.LAUNCHES["block_transfer_grad_v1"]))

    reset_peak(torch, dev, label)
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    # the ngsF-HMM.sh protocol: random inits, replicate r from seed + r
    box = [stack_restart_states(gl, R, seed, device=dev)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    with MafTimer(torch, dev) as maf_timer:
        # handed over without a reference kept here: run_em_restarts holds
        # only its flattened copy
        res = run_em_restarts(gl, dist, box.pop(), opts, trace=trace,
                              device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    counts = dict(cuda_lib.LAUNCHES)
    plain = dict(cuda_lib.PLAIN_CALLS)

    # ---- what came out
    need = V1_KERNELS + ("combine_blocks", "viterbi") + SLAB_KERNELS
    if dev.type == "cuda":
        if plain:
            fail(f"[{label}] the path called plain versions: {plain}")
        missing = [k for k in need if counts.get(k, 0) < 1]
        if missing:
            fail(f"[{label}] never launched: {missing} (counts {counts})")
        fused = [k for k in CHAIN_KERNELS[:4] if counts.get(k, 0)]
        if fused:
            fail(f"[{label}] the flattened route launched gl-layout kernels "
                 f"{fused}")
    elif not plain:
        fail("rehearsal: no plain version was called")
    n_it = len(iters)
    if not (opts.min_iters <= n_it <= opts.max_iters):
        fail(f"[{label}] expected 3 or 4 lockstep iterations, ran {n_it}")
    hist = np.array([t for _, t, _, _ in iters])  # [iterations, R]
    if hist.shape != (n_it, R) or not np.all(np.isfinite(hist)):
        fail(f"[{label}] non-finite or misshapen replicate totals: {hist}")
    # freq estimated: each replicate ends above its start, and no step
    # loses more than 1e-4 of |ll| (run_path's gate, per replicate)
    slack = 1e-4 * np.abs(hist[0])
    if not np.all(hist[-1] > hist[0]) or np.any(
            np.diff(hist, axis=0) < -slack):
        fail(f"[{label}] a replicate's log-likelihood went wrong: {hist}")
    if res.best_rep != int(np.argmax(res.rep_lkl)) or not np.array_equal(
            res.rep_lkl, hist[-1]):
        fail(f"[{label}] best replicate {res.best_rep} is not the argmax "
             f"of {res.rep_lkl}")
    best, freq = res.best, res.rep_freq
    if freq.shape != (R, S):
        fail(f"[{label}] per-replicate freq of the wrong shape")
    if not np.all(np.isfinite(freq)) or not np.all((freq >= 0) & (freq <= 1)):
        fail(f"[{label}] freq not finite in [0, 1]")
    st = best.state
    p_ibd = st.p_ibd.cpu().numpy()
    if p_ibd.shape != (S, N) or not np.all((p_ibd >= 0) & (p_ibd <= 1)):
        fail(f"[{label}] best p_ibd not in [0, 1] or of the wrong shape")
    if best.path.shape != (S, N) or not np.isin(best.path, (0, 1)).all():
        fail(f"[{label}] Viterbi path not in {{0, 1}} or of the wrong shape")
    if not np.array_equal(freq[res.best_rep], st.freq.cpu().numpy()):
        fail(f"[{label}] the best state's freq is not its replicate's")
    want = rebuild_eprob(torch.as_tensor(gl[:1000]).to(dev), st.freq[:1000])
    if not torch.equal(st.e_prob[:1000], want):
        fail(f"[{label}] the best replicate's e_prob is not its freq's")
    f_err = np.abs(freq - freq_true[None]).mean(1)
    corr = [float(np.corrcoef(f, freq_true)[0, 1]) for f in freq]
    maf_ms = maf_timer.ms()
    if len(maf_ms) != R * n_it:
        fail(f"[{label}] {len(maf_ms)} est_maf calls in {n_it} iterations "
             f"of {R} replicates")

    log(f"[{label}] S={S} N={N} R={R} ({R * N} columns) float32 freq_est 1: "
        f"init {t_init:.2f} s, init + {n_it} iterations + Viterbi "
        f"{t_all:.2f} s")
    probes = np.diff([0] + [c for _, _, _, c in iters])
    for i, ((dt, tot, act, _), n_str) in enumerate(zip(iters, probes), 1):
        m = maf_ms[(i - 1) * R:i * R]
        log(f"[{label}] iteration {i}: {dt:.3f} s, best tot_lkl "
            f"{tot.max():.3f} (replicate {int(np.argmax(tot)) + 1}), active "
            f"{int(act.sum())}/{R}, transfer+tangent streams {n_str} "
            f"(L-BFGS probes), L-BFGS outer iterations "
            f"{best.opt_iters[i - 1]}, freq M-step {sum(m):.3f} ms "
            f"({R} est_maf_slab calls, {min(m):.3f}-{max(m):.3f} ms each)")
    for r in range(R):
        log(f"[{label}] replicate {r + 1}: logLkl {res.rep_lkl[r]:.3f} "
            f"({res.rep_iters[r]} iters), mean |freq - simulated| {f_err[r]:.4f}, correlation {corr[r]:.3f}"
            + ("  <== best" if r == res.best_rep else ""))
    log(f"[{label}] best replicate {res.best_rep + 1}: Viterbi IBD share "
        f"{best.path.mean():.4f}, mean p_ibd {p_ibd.mean():.4f}")
    if dev.type == "cuda":
        log(f"[{label}] peak torch.cuda.max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[{label}] launches {counts}")
    return counts


def run_ld_path(torch, dev, label, gl, dist, freq_true, indF0, alpha0,
                freq_est):
    """The LD path: init_state(e_prob_calc=2) (the haplotype EM at init and
    the LD emissions) -> run_em with e_prob_calc 2 and freq_est 1 (the
    emission-slab kernels and maf_macro every iteration) or 2 (the
    haplotype EM every iteration) -> Viterbi, from a flat freq 0.2, no
    writers, with the launch counts set to 0 just before and read just
    after; fails unless every kernel of the route was launched, no plain
    version was called, |ll_f - ll_b| <= 1e-3 in every iteration and what
    came out is sound. Returns the launch counts."""
    from ngsf_hmm_tpu_torch.models import em as tem
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    S, N = gl.shape[0], gl.shape[1]
    opts = tem.EMOptions(freq_est=freq_est, e_prob_calc=2, min_iters=3,
                         max_iters=4, verbose=0)
    iters, fwbw = [], []

    def trace(event, **kw):
        if event == "iter_done":
            if dev.type == "cuda":
                torch.cuda.synchronize()
            iters.append((kw["dt"], kw["tot_lkl"],
                          cuda_lib.LAUNCHES["block_transfer_grad_v1"]))

    em_iteration = tem.em_iteration

    def tapped(*a, **kw):  # records each iteration's max |ll_f - ll_b|
        out = em_iteration(*a, **kw)
        fwbw.append(float(out[1].fwbw_maxdiff))
        return out

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    reset_peak(torch, dev, label)
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    with MafTimer(torch, dev, tem, ("haplo_freq",)) as hap_init:
        state = tem.init_state(gl, np.full(S, 0.2), indF0, alpha0,
                               e_prob_calc=2, device=dev)
        sync()
    t_init = time.perf_counter() - t0
    peak_init = peak_gib(torch, dev, reset=True)
    e_head = state.e_prob[1:1001].clone()
    tem.em_iteration = tapped
    try:
        with MafTimer(torch, dev) as maf_timer, MafTimer(
                torch, dev, tem, ("haplo_freq",)) as hap_timer:
            res = tem.run_em(gl, dist, state, opts, trace=trace, device=dev)
            sync()
    finally:
        tem.em_iteration = em_iteration
    del state
    t_all = time.perf_counter() - t0
    counts = dict(cuda_lib.LAUNCHES)
    plain = dict(cuda_lib.PLAIN_CALLS)

    # ---- what came out
    need = V1_KERNELS + ("combine_blocks", "viterbi") + (
        ("maf_macro",) if freq_est == 1 else ())
    if dev.type == "cuda":
        if plain:
            fail(f"[{label}] the path called plain versions: {plain}")
        missing = [k for k in need if counts.get(k, 0) < 1]
        if missing:
            fail(f"[{label}] never launched: {missing} (counts {counts})")
        fused = [k for k in CHAIN_KERNELS[:4] + SLAB_KERNELS
                 if counts.get(k, 0)]
        if fused:
            fail(f"[{label}] the LD route launched gl-slab kernels {fused}")
    elif not plain:
        fail("rehearsal: no plain version was called")
    if not (opts.min_iters <= res.n_iters <= opts.max_iters
            and len(iters) == len(fwbw) == res.n_iters):
        fail(f"[{label}] expected 3 or 4 EM iterations, ran {res.n_iters}")
    h = res.lkl_history
    if not np.all(np.isfinite(h)) or max(fwbw) > 1e-3:
        fail(f"[{label}] log-likelihoods {h}, |ll_f - ll_b| {fwbw}")
    st = res.state
    to_np = lambda t: t.detach().cpu().numpy()
    freq, p_ibd = to_np(st.freq), to_np(st.p_ibd)
    if freq.shape != (S,) or not np.all(np.isfinite(freq)) or not np.all(
            (freq >= 0) & (freq <= 1)):
        fail(f"[{label}] freq not finite in [0, 1] or of the wrong shape")
    if p_ibd.shape != (S, N) or not np.all((p_ibd >= 0) & (p_ibd <= 1)):
        fail(f"[{label}] p_ibd not in [0, 1] or of the wrong shape")
    if res.path.shape != (S, N) or not np.isin(res.path, (0, 1)).all():
        fail(f"[{label}] Viterbi path not in {{0, 1}} or of the wrong shape")
    if not bool(torch.isfinite(st.e_prob).all()):
        fail(f"[{label}] non-finite emissions")
    # freq_est 1 recomputes site 0's emission only (EM.cpp:252): the LD
    # emissions of the other sites stay as init made them
    if freq_est == 1 and not torch.equal(st.e_prob[1:1001], e_head):
        fail(f"[{label}] the LD emissions of sites >= 1 moved")
    if freq_est == 2 and torch.equal(st.e_prob[1:1001], e_head):
        fail(f"[{label}] the LD emissions were not recomputed")
    FINAL_FREQ[label] = freq
    f_err = float(np.abs(freq - freq_true).mean())
    corr = float(np.corrcoef(freq, freq_true)[0, 1])
    log(f"[{label}] freq: mean |freq - simulated| {f_err:.4f}, correlation "
        f"with the simulated {corr:.3f}")
    # the sanity band of run_path for the est_maf freqs; the haplotype
    # EM's freqs are printed only
    if freq_est == 1 and (f_err > 0.2 or corr < 0.3):
        fail(f"[{label}] estimated freq unrelated to the simulated one")
    maf_ms, hap_ms = maf_timer.ms(), hap_timer.ms()
    n_maf = res.n_iters if freq_est == 1 else 0
    n_hap = res.n_iters if freq_est == 2 else 0
    if len(maf_ms) != n_maf or len(hap_ms) != n_hap:
        fail(f"[{label}] {len(maf_ms)} est_maf and {len(hap_ms)} haplotype "
             f"EM calls in {res.n_iters} iterations")

    log(f"[{label}] S={S} N={N} float32 e_prob 2 freq_est {freq_est}: "
        f"init_state {t_init:.2f} s (haplotype EM "
        f"{sum(hap_init.ms()) / 1e3:.2f} s, then the LD emissions), init + "
        f"{res.n_iters} EM iterations + Viterbi {t_all:.2f} s")
    probes = np.diff([0] + [c for _, _, c in iters])
    for i, ((dt, tot, _), n_str) in enumerate(zip(iters, probes), 1):
        step = (f"freq M-step (est_maf_rows) {maf_ms[i - 1]:.3f} ms"
                if freq_est == 1 else
                f"haplotype EM {hap_ms[i - 1] / 1e3:.3f} s")
        log(f"[{label}] iteration {i}: {dt:.3f} s, tot_lkl {tot:.3f}, "
            f"|ll_f - ll_b| {fwbw[i - 1]:.3g}, transfer+tangent streams "
            f"{n_str} (L-BFGS probes), L-BFGS outer iterations "
            f"{res.opt_iters[i - 1]}, {step}")
    log(f"[{label}] mean indF {to_np(st.indF).mean():.4f}, mean alpha "
        f"{to_np(st.alpha).mean():.4f}, Viterbi IBD share "
        f"{res.path.mean():.4f}, mean p_ibd {p_ibd.mean():.4f}")
    if dev.type == "cuda":
        peak = peak_gib(torch, dev)
        log(f"[{label}] peak torch.cuda.max_memory_allocated "
            f"{max(peak_init, peak):.2f} GiB: init_state {peak_init:.2f} "
            f"GiB, run_em {peak:.2f} GiB")
    log(f"[{label}] launches {counts}")
    return counts


def run_cli(dev, seed, n_rep=1, ld=False, gl_bf16=False):
    """python -m ngsf_hmm_tpu_torch once at a small size on files made
    with numpy (n_rep > 1: that many lockstep restarts, the best
    replicate's files; ld: --freq_est 2 --e_prob 2 at 40 individuals, the
    JAX package's warning on stderr; gl_bf16: --gl_bf16 1 at 40
    individuals, the slab est_maf route); exit code and outputs
    checked."""
    S, N = 5000, 40 if ld or gl_bf16 else 12
    gl, dist, _, _, _ = simulate(S, N, seed + 1, n_chrom=2)
    with tempfile.TemporaryDirectory() as tmp:
        geno = os.path.join(tmp, "in.geno")
        np.exp(gl.astype(np.float64)).astype("<f8").tofile(geno)
        pos, chrom, coord = os.path.join(tmp, "in.pos"), 1, 0
        with open(pos, "w") as fh:
            for s in range(S):
                if np.isinf(dist[s]):
                    chrom, coord = chrom + 1, 0
                    coord += 1000
                else:
                    coord += max(1, int(round(dist[s] * 1e6)))
                fh.write(f"chr{chrom}\t{coord}\n")
        out = os.path.join(tmp, "run")
        cmd = [sys.executable, "-m", "ngsf_hmm_tpu_torch", "--geno", geno,
               "--pos", pos, "--n_ind", str(N), "--n_sites", str(S),
               "--freq_est", "2" if ld else "1", "--freq", "e",
               "--indF", "0.1-0.05", "--min_iters", "2", "--max_iters", "3",
               "--out", out, "--device", dev.type, "--n_rep", str(n_rep)]
        if ld:
            cmd += ["--e_prob", "2"]
        if gl_bf16:
            cmd += ["--gl_bf16", "1"]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        if r.returncode != 0:
            fail(f"CLI exited {r.returncode}:\n{r.stdout[-2000:]}\n"
                 f"{r.stderr[-2000:]}")
        if "Final logLkl" not in r.stdout:
            fail("CLI printed no final log-likelihood")
        if os.path.getsize(out + ".geno") != S * N * 24:
            fail("CLI .geno has the wrong size")
        n_lines = sum(1 for _ in open(out + ".indF"))
        if n_lines != 1 + N + S:
            fail(f"CLI .indF has {n_lines} lines, expected {1 + N + S}")
        if not os.path.getsize(out + ".ibd"):
            fail("CLI .ibd is empty")
        final = [l for l in r.stdout.splitlines() if "Final logLkl" in l][0]
        if ld:
            vals = [float(x) for l in open(out + ".indF") for x in l.split()
                    if x != "NA"]
            if not np.all(np.isfinite(vals)):
                fail("CLI --freq_est 2 --e_prob 2: non-finite .indF values")
            if "CORRECTED two-site haplotype EM" not in " ".join(
                    r.stderr.split()):
                fail("CLI --freq_est 2 --e_prob 2: no LD warning on stderr")
            final += "; LD warning on stderr"
        if n_rep > 1:
            reps = [l for l in r.stdout.splitlines()
                    if l.startswith("Replicate ")]
            best = [l for l in reps if "<== best" in l]
            head = float(open(out + ".indF").readline())
            if len(reps) != n_rep or len(best) != 1 or abs(
                    head - max(float(l.split()[3]) for l in reps)) > 1e-4:
                fail(f"CLI --n_rep {n_rep}: replicate lines {reps}, .indF "
                     f"header {head}")
            final += f"; {best[0].strip()}"
        log(f"[cli] exit 0 at S={S} N={N} --n_rep {n_rep}"
            + (" --freq_est 2 --e_prob 2" if ld else "")
            + (" --gl_bf16 1" if gl_bf16 else "")
            + f": {final.strip()}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sites", type=int, default=1_000_000)
    ap.add_argument("--ind", type=int, default=100)
    ap.add_argument("--check-sites", type=int, default=200_003)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true",
                    help="print each kernel's registers and spills")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU, plain versions; exits 3")
    ap.add_argument("--against", metavar="LOG",
                    help="hold main's streams, final tot_lkl and Viterbi "
                    "IBD share to another tree's chip_smoke.py log of the "
                    "same data")
    ap.add_argument("--probe-build", metavar="CSRC",
                    help="only probe_build, on another tree's csrc "
                    "directory; exits 4")
    ap.add_argument("--probes", action="store_true",
                    help="only the build, transfer and est_maf probes at "
                    "the main and restart shapes; exits 4")
    ap.add_argument("--maf-anchor", metavar="OUT",
                    help="only the float64 anchor of the one-launch "
                    "est_maf functions and the exact and ld paths, their "
                    "readings and final freqs written under OUT; exits 4")
    ap.add_argument("--tree", metavar="DIR",
                    help="with --maf-anchor: run another tree's package "
                    "(its ngsf_hmm_tpu_torch under DIR)")
    ap.add_argument("--against-maf", metavar="DIR",
                    help="hold the float64 anchor and the exact and ld "
                    "paths' final freqs to another tree's --maf-anchor "
                    "files under DIR")
    args = ap.parse_args()
    if args.tree:
        if not args.maf_anchor:
            ap.error("--tree needs --maf-anchor")
        sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    torch.set_grad_enabled(False)  # nothing here differentiates
    if args.rehearse:
        dev = torch.device("cpu")
        args.sites, args.ind, args.check_sites = 2003, 33, 1501
    else:
        # ---- phase 1: the device
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                  "False); this script runs on the card only",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda")
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    smi = "cpu rehearsal"
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        log(f"[device] {smi}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")
        global SM_CLOCK_MHZ
        SM_CLOCK_MHZ = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0])
        log(f"[device] highest SM clock {SM_CLOCK_MHZ:.0f} MHz")

        if args.probe_build:
            probe_build(probe_lanes(args.sites, args.ind, args.check_sites),
                        args.probe_build)
            return 4
        if args.maf_anchor:
            cuda_lib.load()
            log(f"[build] {cuda_lib.CSRC} -> {cuda_lib.build()}")
            return run_maf_anchor(torch, dev, args)
        # ---- phase 2: build
        t0 = time.perf_counter()
        if args.ptxas:
            lib = cuda_lib.build(cuda_lib.NVCC_FLAGS + ("-Xptxas", "-v"))
            for name, err in cuda_lib.build_log:
                log(f"[build] {name}:\n{err}")
            os.remove(lib)  # the flag is part of the name: the run below
            #                 builds the library the package itself loads
        cuda_lib.load()
        log(f"[build] {len(cuda_lib.SOURCES)} sources -> "
            f"{cuda_lib.build()} in {time.perf_counter() - t0:.1f} s (set-up)")
        t0 = time.perf_counter()
        probe_build(probe_lanes(args.sites, args.ind, args.check_sites))
        log(f"[probe build] done in {time.perf_counter() - t0:.1f} s")
        if args.probes:
            return run_probes(torch, dev, args)

    # ---- phase 3: every kernel against its plain version
    results = {}
    t0 = time.perf_counter()
    S_c, N = args.check_sites, args.ind
    N_x = 7 if args.rehearse else 20  # the exact est_maf route: N < 32
    R = 3 if args.rehearse else 20  # restart path: ngsF-HMM.sh's N_REP
    gl_c, dist_c, freq_c, F0_c, a0_c = simulate(S_c, N, args.seed + 7,
                                                n_chrom=1)
    step = max(2, min(100_000, S_c // 2))
    dist_c[step::step] = np.inf  # chromosome breaks every ~100k sites
    check_kernels(torch, dev, gl_c, dist_c, freq_c, F0_c, a0_c, "check",
                  results, reference=True)
    # N = 100 and, at fewer sites, every other number of individuals a
    # forward CTA holds on a 132-SM card (2 to 32, the last group partial)
    hooks = ((211, N), (97, 5)) if args.rehearse else ((20_011, N),) + tuple(
        (2_003, n) for n in (263, 521, 1_001, 2_011, 3_001))
    for i, (S_v, N_v) in enumerate(hooks):
        check_viterbi_hooks(torch, dev, S_v, N_v, args.seed + 13 + i)
    check_copy_widths(torch, dev, args.seed + 17,
                      S=301 if args.rehearse else 3001)
    log(f"[check] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    (gl_x, dist_x, freq_x, F0_x, a0_x), gl_t, prep, p_sites, p_slab = (
        exact_shape_inputs(torch, dev, S_c, N_x, args.seed + 11))
    f32 = torch.float32
    exact_results = {}
    rec_x = Recorder(torch, f"exact shape N={N_x}", exact_results)
    check_maf_kernels(torch, dev, prep, p_slab, rec_x, Timer(torch, dev),
                      slab=False, p_sites=p_sites, gl_lin=torch.exp(gl_t))
    anchor_exact(torch, rec_x.label, gl_t, prep, p_sites, p_slab)
    # the LD path's freq M-step below 32 individuals: maf_exact on the
    # [S, 1, N] row view of the gl planes and the snapped posterior
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
    from ngsf_hmm_tpu_torch.ops.hwe import check_interv
    g0_x, g2_x = mk.gl_rows(gl_t)
    p_x = check_interv(p_sites).contiguous()
    e_k = mk.est_maf_rows(g0_x, g2_x, p_x)
    e_p = mk._exact_plain(g0_x[:, None], g2_x[:, None], p_x[:, None],
                          False).reshape(-1)
    err = maf_compare(torch, rec_x, "maf_exact (rows, [S, 1, N] view)",
                      e_k[None], e_p[None], ["freq"])
    exact_results["maf_exact"]["max_abs_err"] = max(
        exact_results["maf_exact"]["max_abs_err"], err)
    del gl_t, prep, p_sites, p_slab, g0_x, g2_x, p_x
    # one shape for each lane geometry of maf_exact
    check_exact_shapes(torch, dev, exact_results, args.seed + 19,
                       333 if args.rehearse else 33_333,
                       (1, 7, 12, 31, 40) if args.rehearse else EXACT_NS)
    log(f"[exact shape] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    check_maf_shapes(torch, dev, results, args.seed,
                     333 if args.rehearse else 33_333)
    log(f"[macro shapes] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gl, dist, freq, F0, a0 = simulate(args.sites, N, args.seed)
    log(f"[main] inputs simulated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_kernels(torch, dev, gl, dist, freq, F0, a0, "main shape", results,
                  probes=True, bf16=True)
    rows, p_m, prep, p_slab, p_raw, slab_raw = maf_rows_inputs(
        torch, dev, gl, dist, freq, F0, a0, raw=True)
    check_maf_macro(torch, rows, p_m, Recorder(torch, "ld shape", results),
                    Timer(torch, dev), slab=(prep, p_slab))
    anchor_macro(torch, rows, p_m, prep, p_raw, slab_raw)
    del rows, p_m, prep, p_slab, p_raw, slab_raw
    log(f"[main shape] kernels checked in {time.perf_counter() - t0:.1f} s")

    # ---- the emission-slab kernels: at the ragged check shape (one
    # replicate, chromosome breaks) and at the restart path's shape (R
    # replicates flattened into R * N columns, emissions of R random
    # initial frequency vectors)
    t0 = time.perf_counter()
    from ngsf_hmm_tpu_torch.models.restart import (flatten_states,
                                                   stack_restart_states)
    from ngsf_hmm_tpu_torch.ops.emissions import calc_emission
    e_c = calc_emission(torch.as_tensor(gl_c).to(dev, f32),
                        torch.as_tensor(freq_c).to(dev, f32)[:, None])
    check_v1_kernels(torch, dev, e_c, dist_c, F0_c, a0_c, "check v1",
                     results)
    del e_c
    flat = flatten_states(stack_restart_states(gl_c, R,
                                               args.seed + 5, device=dev))
    check_v1_kernels(torch, dev, flat.e_prob, dist_c, flat.indF.cpu(),
                     flat.alpha.cpu(), f"restart shape R={R}",
                     results, probe=True)
    del flat
    log(f"[v1] kernels checked in {time.perf_counter() - t0:.1f} s")
    # maf_exact runs on the exact path only: its line keeps the times at
    # that path's shape and the largest error over all three shapes
    exact_results["maf_exact"]["max_abs_err"] = max(
        exact_results["maf_exact"]["max_abs_err"],
        results["maf_exact"]["max_abs_err"])
    results["maf_exact"] = exact_results["maf_exact"]

    # ---- phase 4: the paths (counts set to 0 before each, read after)
    paths, finals = {}, {}
    paths["main"], finals["main"] = run_path(
        torch, dev, "main", gl, dist, freq, F0, a0, 1,
        CHAIN_KERNELS + SLAB_KERNELS + ("maf_macro_slab",), writers=True)
    if args.against:
        against_parent(args.against)
    # the main path on bfloat16 gl slabs, held against main's final state
    paths["bf16"], _ = run_path(
        torch, dev, "bf16", gl, dist, freq, F0, a0, 1,
        BF16_KERNELS + ("combine_blocks", "viterbi", "maf_window"),
        writers=False, gl_bf16=True, against=finals["main"])
    # ld2 on the first check-shape count of the same sites: its haplotype
    # EM every iteration is about 15 s at 10^6 sites (plain torch), which
    # would put the script above half its time limit
    for label, freq_est, S_ld in (("ld", 1, args.sites),
                                  ("ld2", 2, S_c)):
        t0 = time.perf_counter()
        paths[label] = run_ld_path(
            torch, dev, label, np.ascontiguousarray(gl[:S_ld]), dist[:S_ld],
            freq[:S_ld], F0, a0, freq_est)
        log(f"[{label}] path done in {time.perf_counter() - t0:.1f} s")
    del gl
    paths["fixed"], _ = run_path(torch, dev, "fixed", gl_c, dist_c, freq_c,
                                 F0_c, a0_c, 0, CHAIN_KERNELS, writers=True)
    paths["exact"], _ = run_path(torch, dev, "exact", gl_x, dist_x, freq_x,
                                 F0_x, a0_x, 1, CHAIN_KERNELS + ("maf_exact",),
                                 writers=False)
    del gl_x
    paths["restart"] = run_restart_path(torch, dev, gl_c, dist_c, freq_c,
                                        R, args.seed + 5)
    del gl_c
    if args.against_maf:
        against_maf(args.against_maf)
    counts = {name: sum(c.get(name, 0) for c in paths.values())
              for name in KERNELS}
    log(f"[paths] launches per path: {json.dumps(paths)}")
    if dev.type == "cuda" and min(counts.values()) < 1:
        fail(f"a kernel was launched on no path: {counts}")

    # ---- phase 5: the CLI: one run, three lockstep restarts, the LD path,
    # bfloat16 gl slabs
    run_cli(dev, args.seed)
    run_cli(dev, args.seed, n_rep=3)
    run_cli(dev, args.seed, ld=True)
    run_cli(dev, args.seed, gl_bf16=True)

    if args.rehearse:
        log("rehearsal on the CPU finished; no result is printed for it")
        return 3
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(counts[name]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "bytes": r["bytes"],
            "launches_per_path": {p: int(c.get(name, 0))
                                  for p, c in paths.items()},
        })
        if "ms_by_shape" in r:
            kernels[-1]["ms_by_shape"] = r["ms_by_shape"]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
