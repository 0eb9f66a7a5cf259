#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ngsf_hmm_tpu_torch) on one GPU.

    python3 chip_smoke.py

needs one CUDA device and nvcc. It
  1. requires the card and prints its name and power limit,
  2. builds the CUDA kernels from ngsf_hmm_tpu_torch/csrc (set-up time),
     then compiles the transfer kernels, bw_sites, kernels A and B,
     maf_exact, maf_macro and maf_window alone to print their registers,
     spills, residency, waves and SASS loops, for kernel B the SASS of a
     cell and the cells' issue floor, for maf_exact and maf_macro the SASS
     of a pass, a gradient round and a window step and their issue floor,
     for maf_window the SASS of a step and its issue floor, for the scan
     tier's log_chain.cu and maf_log.cu their three largest loops
     (probe_build), and reads the float64 operations of CUDA's exp and
     log and the float32 ones of expf and logf from their SASS, which the
     scan tier's bounds count (probe_transcendentals); then checks on the
     card that exp(+-0.0) is
     1.0 and that the one-exp logsum2 / logsum3 of log_common.cuh give
     the bits of the forms with an exp for every term on edge and random
     arguments (check_logsum_identity),
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
     kernels A and B) and 5,003 x 1,300 (kernel B unstaged), kernel B at
     kernel A's freq equal to kernel A's gradient rows where both take
     the same lanes a site, maf_macro at the LD path's shape, maf_exact on the
     row view at 20 individuals and at 33,333 sites x 1, 7, 12, 31, 40,
     100, 200 and 300 individuals (every lane geometry it can choose) on a
     posterior with cells within EPSILON of 0 and 1; est_maf_exact,
     macro_slab, est_maf_slab (also on bfloat16 slabs) and est_maf_rows
     against ops/maf.est_maf run in float64 at the exact, main and LD
     shapes (f64_anchor); the stream kernels of all three sources at
     3,001 sites x 33 and 34 columns (every copy width of the staged
     kernels, the transfer-and-tangent kernel, the transfer kernel and
     bw_sites also on slabs that start one element into their storage,
     kernel B on slabs one and two elements in); wherever the
     transfer-and-tangent kernel is held, also against the product rule
     carried in float64; the transfer kernel bit-equal to its plain
     version at B = 1, 2 and 3 candidates, and maf_window at every window
     (its fast quotient also against num / den over 2^31 random pairs of
     its range); at the main and restart shapes the
     transfer-and-tangent kernel, the transfer kernel and bw_sites each
     split into the step from registers and the loads alone
     (probe_transfer), and maf_window's longest window into its bytes
     alone and its steps from registers, with its active lane-steps
     against those the warps run (probe_window); at the LD path's
     shape maf_macro split into its real passes, its gradient rounds and
     its windows; the bfloat16 gl exports
     ("_bf16") of the stream and slab est_maf kernels at the main path's
     shape, on bfloat16 slabs of the same gl; the one-launch slab est_maf
     (maf_macro_slab, float32 and bfloat16 slabs) at the main path's shape and at the maf_macro
     shapes, also against est_maf_slab; the combine bit-equal to its plain
     version (candidate 0 of B = 2 equal to B = 1), timed at every shape
     the streams are checked at (the restart path's nb = 136 among them);
     Viterbi with zero path mismatches (both variants; the compat one
     only at the main shape, where the plain loop, replayed from CUDA
     graphs a chunk of sites at a time, still takes some 15 s), its log
     line beside the forward chain's derived floor and that chain's own
     measured time, and at 20,011 x 100 and 2,003 x 263 to 3,001 (every
     group of individuals a forward CTA holds) with chromosome breaks,
     forced (init_logits, final_state) and traceback blocks of 256, 1 and
     77 sites; the float64 scan tier's kernels (log_block_transfer,
     log_combine, log_sweep in both modes, maf_log, also on a replicate's
     strided columns and in float32) at the ragged check shape, at the
     scan path's shape and at the scan_restart path's (its replicates'
     emissions in 2,000 columns, the chain's own geometry there, maf_log
     on a replicate's strided columns), and at 2,003 x 33 (a site at
     distance 0) the
     chain functions against the per-site oracle loops and float64
     Viterbi against its plain version; log_block_transfer and log_combine
     bit for bit (log_combine also with one chunk, and at 2,003 x 33 with
     chunks of one block), and at 20,011 x 40 on extreme inputs (F = 0, 1
     and 1e-300, a subnormal decay, -inf emissions, an 800-nat emission
     gap, rows drifting thousands of nats apart, runs of distance 0) at
     their geometry's blocks and at blocks of 1,200 sites; the float32
     instances of the three chain kernels (log_sweep in both modes,
     parking and recomputing) bit for bit at the ragged check shape, the
     scan path's and the scan_restart path's, each printed against the
     float64 kernel on the same inputs, and at 20,011 x 40 on extreme
     inputs scaled to float32's range (F = 0, 1 and 1e-40, a subnormal
     float32 decay, emission gaps past -87 nats and past the 2^20-nat
     clamp, -inf emissions, runs of distance 0); maf_log also
     at 33,333 sites x 20, 33, 100 and 130 individuals, 10,007 x 1,000
     and 1,001 x 4,000 (every segment width its geometry chooses, and
     cells read from
     device memory), printing the passes its warps run against those its
     sites need and the share of cells that take their own prior logs,
  4. drives twelve paths, each with the launch counts set to 0 just
     before and read just after: init_state -> run_em (min_iters 3,
     max_iters 4, Viterbi) [-> the three writers]
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
       scan     the main path's data in float64 on the scan tier (the
                JAX package's default, numerics "log": the log chain
                kernels, maf_log, float64 Viterbi), no writers; its final
                F set beside main's float32 F (the gap printed, no gate),
       scan32   the same data in float32 on the scan tier (--dtype
                float32: the float32 chain kernels, maf_log's float32
                instance, float32 Viterbi), no writers; its final F, freq,
                tot_lkl and IBD share set beside scan's (no gate),
       main64   the main path's data and options with a float64 state
                (--kernel pallas, the JAX CLI's default --dtype): the
                fused kernels read float32, their outputs are cast to the
                state's float64; no writers; held against main's final
                freq and ind_lkl at the bf16 envelopes, its streams,
                tot_lkl and IBD share printed beside main's,
       fixed    200,003 x 100, freq_est 0 (frequencies held fixed), with
                the writers,
       exact    200,003 x 20, freq_est 1 on the exact est_maf kernel (fewer
                than 32 individuals have no macro schedule),
       restart  200,003 x 100 with 20 replicates (the ngsF-HMM.sh protocol:
                stack_restart_states -> run_em_restarts, replicates
                flattened into 2,000 columns on the emission-slab kernels,
                freq_est 1, best-replicate Viterbi, no writers),
       scan_restart  the same on the scan tier (2,000 columns of the log
                chain, maf_log a replicate, float64),
       scan_ld_restart  200,003 x 100 with 4 replicates on the scan tier
                with --freq_est 2 --e_prob 2 (each replicate's haplotype
                EM at init and every iteration on its own columns, the
                chain over 400 columns),
       ld       the main path's data with --e_prob 2 --freq_est 1 (the LD
                path: haplotype EM at init, LD emissions, the emission-slab
                kernels and maf_macro every iteration), no writers,
       ld2      the first 200,003 sites of that data with --freq_est 2
                --e_prob 2 (the haplotype EM every iteration), no writers,
  5. runs the CLI eight times at a small size: on the fused tier (--dtype
     float32 --kernel pallas) with --freq e, freq_est 1; once more with
     --n_rep 3; once with --freq_est 2 --e_prob 2; once with --gl_bf16 1;
     then once on the default tier (the float64 scan tier); then once
     with --dtype float32 (the float32 scan tier), once with --kernel
     pallas (a float64 state on the fused tier) and once with --n_rep 3
     --freq_est 2 --e_prob 2 on the default tier.
--against LOG also holds main's streams per iteration, final tot_lkl
and Viterbi IBD share to another tree's log of the same run (the parent's,
in one call). --before DIR times the scan tier's kernels of another
tree's package (DIR's, the parent's) and of this tree's in turns (DIR,
this, this, DIR; one process each, --scan-times OUT [--tree DIR]
[--against-times REF]) at the scan and scan_restart shapes, each tree
through its own wrappers at its own geometry; this tree's chain kernels
must stay within the gates of the kernels against their plain versions
of the other's outputs at the other's geometry, each on the other's
inputs (block products and walks; the grad sweep's sums and 512 seeded
rows of the posterior from the other's walks) and maf_log inside its
gates of the other's; exits 4. --probes runs only the
measurements and exits 4;
--probe-build CSRC runs only probe_build on another tree's sources.
--maf-anchor OUT [--tree DIR] runs only the float64 anchor, the main
(without the writers), bf16, exact, ld, ld2, restart, scan and
scan_restart paths, the fused tier's --freq e estimate at the main shape
and its CLI runs with --freq e (one run, the LD path) (of DIR's
package), writes their readings, final
freqs and CLI outputs under OUT and exits 4; --against-maf OUT, in a full
run or beside --maf-anchor, then sets this run's anchor beside them and
holds those paths' final freqs to them (printing whether they are
bit-equal; beside --maf-anchor also the CLI outputs).

The fused-tier paths and CLI runs name numerics "pallas" / --dtype float32
--kernel pallas, the scan tier being the default. Any failure exits
non-zero. The last line printed is
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
# float64 outside the tensor cores: half the float32 rate
PEAK_F64 = 33.5e12

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
# factors 13, the 16 fused updates 32, their 8 products 8); the transfer
# kernel (csrc/transfer_stream.cuh without the tangents) its primal step
# alone, per candidate. The staged backward stream (csrc/bw_sites.cu) the
# same per-lane emissions 14, decay 3 and matrix 8, then its step 13 (the
# ratio's sum, clamp and division 3, the 2-vector product 6, the two
# maxima 2, the rescale 2).
FLOPS_CELL = {
    "block_transfer_grad": 14 + 3 + 8 + 20 + 57,
    "block_transfer": 14 + 3 + 8 + 20,
    "bw_sites": 14 + 3 + 8 + 13,
    "fw_post": 37 + 18,
    "block_transfer_grad_v1": 3 + 8 + 20 + 57,
    "block_transfer_v1": 3 + 8 + 20,
    "bw_sites_v1": 3 + 8 + 13,
    "fw_post_v1": 12 + 18,
    # est_maf (csrc/maf_common.cuh): the planes of a cell, one pass over
    # it and one gradient evaluation in the unfused form of the plain
    # version, and one step of the per-site window (maf_advance); the same
    # in the fused form of the kernels (maf_cell_fma, with f (1 - f) once
    # a lane and pass; the window steps of an active site,
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

# The scan tier's kernels (csrc/log_chain.cu, csrc/maf_log.cu) against
# their plain versions: the same float64 operations in the same order on
# the card (the plain versions' torch.exp / torch.log and the kernels' exp /
# log are both CUDA's float64 libm), so what is left is the last bits of
# those functions carried along a chain: log values relative to
# max(|x|, 1), posteriors absolute, the gradient's block sums relative to
# max(|g|, 1). maf_log sums over the individuals in a warp's butterfly
# where the plain version takes torch.sum: freq relative LOG_MAF_RTOL
# except at sites where that rounding flips the EPSILON test (share and
# step as MAF_FLIP_SHARE / MAF_FREQ_ATOL). Against the per-site oracle
# loops (another association of the same steps): the JAX package's float64
# gates (tests/test_torch_log_chain.py).
LOG_RTOL = 1e-12
LOG_P_ATOL = 1e-9
LOG_G_RTOL = 1e-9
LOG_MAF_RTOL = 1e-10
ORACLE_LL_RTOL, ORACLE_P_ATOL, ORACLE_G_RTOL = 1e-10, 1e-10, 1e-9
# Float64 operations a (site, column) of the scan tier's kernels, counted
# from csrc/log_chain.cu and csrc/maf_log.cu with an exp taken as E and a
# log as L operations: the float64 FMA (two), add and multiply
# instructions of CUDA's exp and log, which probe_transcendentals reads
# from their SASS on the card (the CPU rehearsal keeps the estimate of 20
# each below). logsum2 = exp + log + max, a subtraction, 1 + (m - m) in
# place of the maximum term's exp (log_common.cuh), 2 adds; logsum3 the
# same with 2 exps. The site's decay and four log transitions 1 + exp +
# 6 + 4 log; a forward or backward step of a 2-vector 2 logsum2 + 6 adds.
def flops_log(E, L):
    logsum2 = E + L + 6
    logsum3 = 2 * E + L + 9
    site = 7 + E + 4 * L
    step = 2 * logsum2 + 6
    return {
        # per (site, column), the linear chain (log_common.cuh: lx_site,
        # lx_entry): the decay (a multiply and its exp), 1 - x, the four
        # transitions (2 multiplies, 2 adds), the emission gap and its
        # exp, the offset's add; each of the four entries two products,
        # two scalings by powers of two, their sum and the emission factor
        # (the four logs a lane at the block's end are not counted)
        "log_block_transfer": 2 + E + 1 + 4 + 1 + E + 1 + 4 * 6,
        # per (block, column): what the function needs, a step forward and
        # one backward (the two-level kernel forms the chunk products
        # besides, about twice that work, which the bound leaves out)
        "log_combine": 2 * step,
        # per (site, column): the site (once: the backward pass reads its
        # transitions where the forward pass parked them) and a step
        # forward and backward, then p = exp(fw1 + bw1 - L) (posterior
        # mode) or the decay again, the four u terms and the two sums
        # (grad mode)
        "log_sweep": site + 2 * step + 2 + E,
        "log_sweep_grad": site + 2 * step + 1 + E + 4 + 4 * (E + 1) + 17,
        # maf_log as csrc/maf_log.cu runs it: per (site, individual, pass)
        # post_prob and the sums; per (site, individual, pass) whose F is
        # neither 0 nor 1 its own calc_hwe; per (site, pass) the five
        # snapped-prior logs, their five priors, A, B, pq, 2 pq, 1 - f and
        # the update (2 adds, an add, the division, |prev - freq|)
        "maf_log_cell": 3 + logsum3 + 2 * (E + 1) + 5,
        "maf_log_own": 10 + 3 * L,
        "maf_log_site": 5 * L + 10 + 5 + 5,
    }


FLOPS_LOG = flops_log(20, 20)
# the same counts for the float32 instances of log_chain.cu, with expf and
# logf read from their SASS (FFMA as two, FADD, FMUL and the MUFU
# approximation each one operation); log_combine walks in float64 in both
FLOPS_LOG32 = flops_log(10, 10)

# one exp and one log of each float type, each alone in a kernel
TRANSCENDENTAL_PROBE_CU = r"""
#include <math.h>
extern "C" __global__ void probe_exp(const double* x, double* y) {
    y[threadIdx.x] = exp(x[threadIdx.x]);
}
extern "C" __global__ void probe_log(const double* x, double* y) {
    y[threadIdx.x] = log(x[threadIdx.x]);
}
extern "C" __global__ void probe_expf(const float* x, float* y) {
    y[threadIdx.x] = expf(x[threadIdx.x]);
}
extern "C" __global__ void probe_logf(const float* x, float* y) {
    y[threadIdx.x] = logf(x[threadIdx.x]);
}
"""


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
    # the float64 scan tier (port-only: the JAX package runs lax.scans)
    "log_block_transfer": (
        "ngsf_hmm_tpu_torch/csrc/log_chain.cu",
        "ngsf_hmm_tpu/models/hmm.py:51 (lax.scan, no TPU kernel)"),
    "log_combine": (
        "ngsf_hmm_tpu_torch/csrc/log_chain.cu",
        "ngsf_hmm_tpu/models/hmm.py:158 (lax.scan, no TPU kernel)"),
    "log_sweep": (
        "ngsf_hmm_tpu_torch/csrc/log_chain.cu",
        "ngsf_hmm_tpu/models/hmm.py:94 (lax.scans, no TPU kernel)"),
    "maf_log": (
        "ngsf_hmm_tpu_torch/csrc/maf_log.cu",
        "ngsf_hmm_tpu/ops/maf.py:90 (lax.while_loop, no TPU kernel)"),
}
LOG_KERNELS = ("log_block_transfer", "log_combine", "log_sweep", "maf_log")
# the float32 instances of the three chain kernels (the float32 scan tier;
# maf_log's float32 instance counts under maf_log)
LOG32_KERNELS = tuple(k + "_f32" for k in LOG_KERNELS[:3])
for _k in LOG_KERNELS[:3]:
    KERNELS[_k + "_f32"] = KERNELS[_k]
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

    def record(self, name, err, ms, plain_ms, nbytes, flops, peak=PEAK_F32):
        b_ms, f_ms = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
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
        # ---- kernel B at kernel A's final freq: the same cells summed in
        # the same order, so at the same lanes a site the same bits
        G_b, _ = mk.sums_grad_geometry(N, g0.element_size())
        b_at_a = mk._k_maf_sums_grad(g0, g2, p_slab, a_k[0].contiguous())
        same = torch.equal(b_at_a, a_k[4:])
        log(f"[{rec.label}] maf_sums_grad{sfx} (G = {G_b}) at kernel A's "
            f"freq (G = {mk.state_grad_geometry(N)[0]}): torch.equal "
            f"kernel A's gradient rows {same}")
        if G_b == mk.state_grad_geometry(N)[0] and not same:
            fail(f"[{rec.label}] maf_sums_grad{sfx} differs from kernel A's "
                 "gradient rows at the same freq and lanes a site")
        del b_at_a
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
                        cells * (fc["maf_planes"] + fc["maf_grad_fma"]))
                grads = b_k
            w_k, ms = timer(lambda: mk._k_maf_window(st, grads, passes, M_r))
            tally = []
            w_p, pms = timer(lambda: mk._virtual_window_plain(
                st, grads, passes, M_r, tally), reps=1, warm=0)
            err = maf_compare(torch, rec, f"maf_window (M = {M_r})", w_k,
                              w_p, ["freq", "num", "den", "active"])
            if dev.type == "cuda":
                if not torch.equal(w_k, w_p):
                    fail(f"[{rec.label}] maf_window (M = {M_r}) is not "
                         "bit-equal to its plain version")
                log(f"[{rec.label}] maf_window (M = {M_r}) torch.equal its "
                    "plain version: True")
            # the line keeps the last (longest) window's times; the bytes
            # this window's data needs: the state in and out, the
            # gradients of the sites active at entry
            if not sfx:
                rec.record("maf_window", err, ms, pms,
                           sites * 32 + float(st[3].sum()) * 16,
                           total(tally) * fc["maf_window_step_active"])
                if r == len(Ms) - 1 and dev.type == "cuda":
                    probe_window(torch, timer, rec.label, st, grads, passes,
                                 M_r)
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
                *map(int, mk.sums_grad_geometry(N, g0.element_size())),
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
# The backward stream (csrc/bw_sites.cu) split the same way:
#   bw_step_alone  its own step from registers (the prior coefficients once,
#                  the ratio summed instead of written), lane per thread;
#   the lane-order loads are memory_alone's (the same two slabs and
#                  compacts); the kernel's own staging alone is its MEM
#                  instantiation.
# Built and timed by probe_transfer. Measurements only.
TRANSFER_PROBE_CU = r"""
#include "block_transfer_grad.cu"
#include "bw_sites.cu"
#include "maf_window.cu"

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

// The kernel's own step (TransferLane, with the tangents if TANG: the
// transfer-and-tangent kernel, else the transfer kernel at B = 1) from
// registers; the prior coefficients, which the kernel computes once per
// (site, block), are computed once here and laundered at every site.
template <class Src, bool TANG>
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
    TransferLane<TANG> L;
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
__global__ void __launch_bounds__(128) bw_step_alone(
        Src src, const float* Fp, const float* ap, const float* ends,
        float* out, int bs, int nb, int N) {
    const long long lanes = (long long)nb * N;
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int j = (int)(lane / N);
    const int n = (int)(lane - (long long)j * N);
    const float F = Fp[n], a = ap[n];
    float w0 = ends[lane], w1 = ends[lanes + lane], acc = 0.0f;
    float l0[NGSF_UNROLL], l2[NGSF_UNROLL], ff[NGSF_UNROLL], dd[NGSF_UNROLL];
    chunk_load(src, 0, bs, nb, j, lane, lanes, l0, l2, ff, dd);
    Prior q[NGSF_UNROLL];
#pragma unroll
    for (int u = 0; u < NGSF_UNROLL; ++u) q[u] = site_prior(ff[u]);
    for (int r0 = 0; r0 < bs; r0 += NGSF_UNROLL) {
#pragma unroll
        for (int u = 0; u < NGSF_UNROLL; ++u) {
            launder(l0[u]); launder(l2[u]); launder(dd[u]);
            acc += w1 / fmaxf(w0 + w1, NGSF_TINY);
            SiteK k;
            if (Src::kFreq) {
                launder(q[u].i0); launder(q[u].pr0); launder(q[u].pq2);
                launder(q[u].pr2); launder(q[u].s10); launder(q[u].het);
                launder(q[u].s12);
                k = site_emit(l0[u], l2[u], q[u], dd[u], a);
            } else {
                k = site_em(l0[u], l2[u], dd[u], a);
            }
            float m00, m01, m10, m11;
            site_matrix(k, F, m00, m01, m10, m11);
            const float b0 = m00 * w0 + m01 * w1;
            const float b1 = m10 * w0 + m11 * w1;
            int ex = 0;
            const float sc = pow2_scale(fmaxf(fmaxf(b0, b1), NGSF_TINY), ex);
            w0 = b0 * sc;
            w1 = b1 * sc;
        }
    }
    out[lane] = acc + w0 + w1;
}

template <class Src>
static int run_probe(int kind, Src src, const float* F, const float* al,
                     const float* ends, float* out, int bs, int nb, int N,
                     void* st) {
    const long long lanes = (long long)nb * N;
    const unsigned grid = (unsigned)((lanes + 127) / 128);
    cudaStream_t s = (cudaStream_t)st;
    switch (kind) {
    case 0: compute_alone<<<grid, 128, 0, s>>>(src, F, al, out, bs, nb, N); break;
    case 4: memory_alone<<<grid, 128, 0, s>>>(src, out, bs, nb, N); break;
    // the kernel's own step, and its staged loads alone (the transfer
    // kernel's too: the same staging)
    case 1: compute_alone_own<Src, true><<<grid, 128, 0, s>>>(src, F, al, out, bs, nb, N); break;
    case 7: compute_alone_own<Src, false><<<grid, 128, 0, s>>>(src, F, al, out, bs, nb, N); break;
    case 2: return launch<Src, true>(src, F, al, out, bs, nb, N, st);
    // the backward stream's own step, and its staged loads alone
    case 5: bw_step_alone<<<grid, 128, 0, s>>>(src, F, al, ends, out, bs, nb, N); break;
    case 6: return launch<Src, true>(src, F, al, ends, out, bs, nb, N, st);
    default: return -1;
    }
    return (int)cudaGetLastError();
}

// source: 0 float32 gl, 1 bfloat16 gl, 2 emission slabs (v1)
extern "C" int transfer_probe(int kind, int source, const void* a,
                              const void* b, const float* fc, const float* dc,
                              const float* F, const float* al,
                              const float* ends, float* out, int bs, int nb,
                              int N, void* st) {
    if (source == 0)
        return run_probe(kind, GlSource<float>{(const float*)a, (const float*)b, fc, dc},
                         F, al, ends, out, bs, nb, N, st);
    if (source == 1)
        return run_probe(kind, GlSource<__nv_bfloat16>{(const __nv_bfloat16*)a,
                                                        (const __nv_bfloat16*)b, fc, dc},
                         F, al, ends, out, bs, nb, N, st);
    return run_probe(kind, EmSource{(const float*)a, (const float*)b, nullptr, dc},
                     F, al, ends, out, bs, nb, N, st);
}

// maf_window's steps from registers: site i runs the window of site
// i % sub (the first sub sites of st / gr, which stay in L2), through the
// kernel's own window_site; nothing is stored unless freq comes out -1.
__global__ void __launch_bounds__(NGSF_WIN_THREADS) window_alone(
        const float* st, const float* gr, float* out, long long sites,
        long long sub, int passes0, int M) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= sites) return;
    const long long q = i % sub;
    float freq = st[q], num = st[sub + q], den = st[2 * sub + q];
    if (st[3 * sub + q] == 0.0f) return;
    const int n_in = max(0, min(M, NGSF_MAF_ITER_MAX - passes0));
    const bool on = window_site(freq, num, den, gr[q], gr[sub + q],
                                gr[2 * sub + q], gr[3 * sub + q], n_in, M);
    if (freq == -1.0f) out[0] = num + den + (on ? 1.0f : 0.0f);
}

__device__ __forceinline__ unsigned long long mix64(unsigned long long z) {
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
}

// maf_window's div_rn_fast against the IEEE division (num / den) over n
// pairs of positive floats, biased exponents drawn in [elo, ehi) and
// mantissas at random (a counter-based hash of seed); the count that
// differ in any bit is added into *bad.
__global__ void div_pairs(unsigned long long seed, long long n, int elo,
                          int ehi, unsigned long long* bad) {
    unsigned long long cnt = 0;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        const unsigned long long h = mix64(seed + 2 * i);
        const unsigned long long g = mix64(seed + 2 * i + 1);
        const unsigned span = (unsigned)(ehi - elo);
        const float a = __uint_as_float(
            ((elo + (unsigned)(h >> 40) % span) << 23) | (unsigned)(h & 0x7FFFFF));
        const float b = __uint_as_float(
            ((elo + (unsigned)(g >> 40) % span) << 23) | (unsigned)(g & 0x7FFFFF));
        if (__float_as_uint(a / b) != __float_as_uint(div_rn_fast(a, b))) ++cnt;
    }
    if (cnt) atomicAdd(bad, cnt);
}

extern "C" int div_probe(unsigned long long seed, long long n, int elo,
                         int ehi, unsigned long long* bad, void* stream) {
    div_pairs<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(seed, n, elo, ehi,
                                                          bad);
    return (int)cudaGetLastError();
}

extern "C" int window_probe(const float* st, const float* gr, float* out,
                            long long sites, long long sub, int passes0,
                            int M, void* stream) {
    const unsigned grid =
        (unsigned)((sites + NGSF_WIN_THREADS - 1) / NGSF_WIN_THREADS);
    window_alone<<<grid, NGSF_WIN_THREADS, 0, (cudaStream_t)stream>>>(
        st, gr, out, sites, sub, passes0, M);
    return (int)cudaGetLastError();
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


PROBE_SOURCES = ("block_transfer_grad.cu", "bw_sites.cu", "block_transfer.cu",
                 "maf_state_grad.cu", "maf_sums_grad.cu", "maf_exact.cu",
                 "maf_macro.cu", "maf_window.cu", "log_chain.cu", "maf_log.cu")
# the scan tier's sources: probe_build prints their lines with log_probe_line
LOG_PROBE_SOURCES = ("log_chain.cu", "maf_log.cu")
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


def _nested(a, b):
    """Whether loop b (instructions, opcodes, first, last) lies in loop a."""
    return a[2] <= b[2] and b[3] <= a[3] and a != b


def _flat(lp, lps):
    """Loop lp's instructions outside the loops nested in it."""
    return sum(1 for q in range(lp[2], lp[3] + 1) if not any(
        o[2] <= q <= o[3] for o in lps if _nested(lp, o)))


def sums_grad_probe_line(nice, props, loops, shapes):
    """probe_build's line for a kernel B instantiation at each shape that
    runs it (sums_grad_geometry; aligned slabs: 16-byte copies):
    registers, spills, shared memory (the static, and the ring of
    tiles), resident CTAs, tiles a CTA, the SASS of a cell (the largest
    loop inside the tile loop, the unrolled cell loop of the rcp_fast
    path, over its 4 cells) and of the tile loop outside its inner loops
    (the copies, the peeled cells of a lane's last round, the exact
    reciprocal's path, the sums: not all run on every tile), and the
    issue floor of the cells alone: ceil(N / G) cells a lane for every
    warp of every tile over 4 warp instructions a cycle on 132 SMs at the
    highest SM clock."""
    import re

    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk

    m = re.search(r"k_maf_sums_grad<\(int\)(\d+), \(int\)(\d+), (\w+)>",
                  nice)
    if not loops:
        return
    n_ins, _, _, lps = loops
    if not m:  # a tree whose kernel B gives a site one warp, CPL cells a lane
        m = re.search(r"k_maf_sums_grad<\(int\)(\d+), (\w+)>", nice)
        for label, sh in shapes.items():
            cpl = 1 if sh["N"] <= 32 else 2 if sh["N"] <= 64 else (
                4 if sh["N"] <= 128 else 0)
            if not m or int(m.group(1)) != cpl or (
                    "bfloat16" in m.group(2)) != sh.get("bf16", False):
                continue
            log(f"[probe build] {nice[:70]} at {label} ({sh['sites']} x "
                f"{sh['N']}): {props['regs']} registers, spills "
                f"{props.get('spill', (0, 0))}; "
                f"{resident_ctas(props['regs'], 256, props['smem'])} CTAs "
                f"of 256 an SM; {n_ins} SASS instructions for one site a "
                f"warp, loops {[lp[0] for lp in lps]}")
        return
    if not lps:
        return
    G, V, esz = int(m.group(1)), int(m.group(2)), (
        2 if "bfloat16" in m.group(3) else 4)
    tile = max(lps, key=lambda lp: lp[0])
    inner = [lp for lp in lps if _nested(tile, lp)]
    cell = max(inner, key=lambda lp: lp[0]) if inner else None
    per_cell = _flat(cell, lps) / 4 if cell else 0.0
    for label, sh in shapes.items():
        if sh.get("bf16", False) != (esz == 2):
            continue
        N, sites = sh["N"], sh["sites"]
        if mk.sums_grad_geometry(N, esz) != (G, V != 0) or V not in (0, 16):
            continue
        ts = mk.SUMS_GRAD_THREADS // G
        ring = mk.sums_grad_ring_bytes(G, N, esz) if V else 0
        ctas = resident_ctas(props["regs"], 256, props["smem"] + ring)
        ntiles = -(-sites // ts)
        rate = 4 * SM_COUNT * SM_CLOCK_MHZ * 1e3  # warp instructions a ms
        floor = ntiles * 8 * -(-N // G) * per_cell / rate
        log(f"[probe build] {nice[:70]} at {label} ({sites} x {N}): "
            f"{props['regs']} registers, spills "
            f"{props.get('spill', (0, 0))}, smem {props['smem']} + ring "
            f"{ring} B; {ctas} CTAs of 256 an SM "
            f"({ntiles / (SM_COUNT * max(ctas, 1)):.1f} tiles of {ts} sites "
            f"a CTA); {n_ins} SASS instructions; cell loop "
            f"{cell[0] if cell else 0} SASS for 4 cells ({per_cell:.1f} a "
            f"cell), tile loop {_flat(tile, lps)} outside its inner loops; "
            f"issue floor of the cells {floor:.3f} ms")


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
    nested = _nested
    top = [lp for lp in lps if not any(nested(o, lp) for o in lps)]
    flat = lambda lp: _flat(lp, lps)
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


def window_probe_line(nice, props, loops, shapes, source):
    """probe_build's line for maf_window: registers, spills, resident CTAs
    of 256 threads, the SASS of a step (the window loop's instructions
    outside its nested loops over the steps it unrolls, NGSF_WIN_UNROLL
    in the source, 1 where the source has none) with its commonest
    opcodes, and the issue floor at the window each shape gives (every
    warp of 32 sites issuing for all M steps) over 4 warp instructions a
    cycle on 132 SMs at the highest SM clock. The window loop is the
    largest loop without the division's operand check (FCHK), the fast
    one, where the source has one; the loop with FCHK (the true
    division's) is printed beside it."""
    import re

    if not loops or not loops[3]:
        return
    m = re.search(r"#define NGSF_WIN_UNROLL (\d+)", source)
    unroll = int(m.group(1)) if m else 1
    n_ins, _, _, lps = loops
    top = [lp for lp in lps if not any(_nested(o, lp) for o in lps)]
    fast = [lp for lp in top if "FCHK" not in lp[1]]
    exact = [lp for lp in top if "FCHK" in lp[1]]
    lp = (fast or exact)[0]
    per = _flat(lp, lps) / unroll
    ops = ", ".join(f"{o} {c}" for o, c in sorted(
        lp[1].items(), key=lambda x: -x[1])[:10])
    ctas = resident_ctas(props["regs"], 256, props["smem"])
    floors = ", ".join(
        f"{k} (M = {v['M']}) "
        f"{per * v['M'] * -(-v['sites'] // 32) / (4 * SM_COUNT * SM_CLOCK_MHZ * 1e3):.4f} ms"
        for k, v in shapes.items())
    other = (f"; the true division's loop {exact[0][0]} for {unroll} steps"
             if fast and exact else "")
    log(f"[probe build] {nice[:60]}: {props['regs']} registers, spills "
        f"{props.get('spill', (0, 0))}; {ctas} CTAs of 256 an SM; {n_ins} "
        f"SASS instructions; the window loop {lp[0]} for {unroll} steps "
        f"[{ops}], {per:.1f} a step outside its nested loops; issue floor "
        f"{floors}{other}")


def log_probe_line(nice, props, loops, shapes):
    """probe_build's line for a scan-tier kernel (log_chain.cu,
    maf_log.cu) at each shape: registers, spills, shared memory, resident
    CTAs, waves, and its three largest SASS loops with their commonest
    opcodes (the float64 DFMA / DADD / DMUL and MUFU among them). The
    lane kernels run a thread a (block, column) lane, log_combine its
    CTAs of models/hmm.py:log_combine_launch; maf_log runs the geometry its
    template arguments name (maf_log_launch). For log_block_transfer also
    the SASS instructions of its site loop outside the loops nested in it
    and the issue floor they give at one instruction a cycle of each of
    the 4 schedulers of 132 SMs."""
    import re

    if not loops:
        return
    n_ins, lp, flat, _ = loops
    from ngsf_hmm_tpu_torch.models.hmm import (log_combine_chunk_len,
                                               log_combine_launch)
    from ngsf_hmm_tpu_torch.ops.maf import maf_log_launch
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    lc = cuda_lib.LOG_CHAIN_THREADS
    for label, sh in shapes.items():
        # each instance at its own float type's geometry (maf_log: float64)
        if sh["float32"] != ("k_log_" in nice and "<float" in nice):
            continue
        smem = props["smem"]
        floor = ""
        if "k_log_combine" in nice:
            _, threads, ctas_n = log_combine_launch(
                sh["nb"], sh["C"], log_combine_chunk_len(sh["nb"]))
            total = threads * ctas_n
        elif "k_log_" in nice:
            threads, total = lc, sh["nb"] * sh["C"]
            if "k_log_block_transfer" in nice and flat:
                ms = flat * sh["S"] * sh["C"] / 32 / (
                    4 * SM_COUNT * SM_CLOCK_MHZ * 1e3)
                floor = (f"; the site loop {flat} SASS instructions a site "
                         f"and column, issue floor {ms:.3f} ms")
        else:
            if "k_maf_log<float" in nice:
                continue  # the float32 instance: not on the scan tier
            args = re.search(r"k_maf_log<([^>]*)>", nice)
            ints = [int(a) for a in re.findall(r"\(int\)(\d+)",
                                                args.group(1))] if args else []
            G, C, warps, dyn = maf_log_launch(sh["N"], 8)
            if not ints or ints[0] != G:
                continue
            threads, smem = 32 * warps, smem + dyn
            total = -(-sh["S"] * G // 32) * 32
        ctas = resident_ctas(props["regs"], threads, smem)
        waves = total / (SM_COUNT * ctas * threads) if ctas else float("inf")
        top = "; ".join(
            f"{n} ins [" + ", ".join(
                f"{o} {c}" for o, c in sorted(ops.items(),
                                               key=lambda x: -x[1])[:10])
            + "]" for n, ops in lp[:3])
        log(f"[probe build] {nice[:90]} at {label}: {props['regs']} "
            f"registers, spills {props.get('spill', (0, 0))}, smem {smem} "
            f"B; {ctas} CTAs of {threads} an SM, {total} threads "
            f"({waves:.2f} waves); {n_ins} SASS instructions; loops: "
            f"{top or 'none'}{floor}")


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
            if src == "maf_sums_grad.cu":
                sums_grad_probe_line(nice, p, loops.get(name), shapes)
                continue
            if src == "maf_window.cu":
                window_probe_line(nice, p, loops.get(name), shapes,
                                  (csrc / src).read_text())
                continue
            if src in LOG_PROBE_SOURCES:
                log_probe_line(nice, p, loops.get(name), shapes)
                continue
            n_ins, lp, flat, _ = loops.get(name, (0, [], 0, []))
            threads = 256 if "maf" in src else 128
            # the staged stream kernels' dynamic shared memory: three
            # tiles of 8 sites x 128 lanes of both slabs, 3 blocks' compacts
            smem = p["smem"]
            stream = ("k_block_transfer" in nice or "k_bw_sites" in nice
                      or "k_transfer_stream" in nice)
            staged = stream and "(bool)" in nice
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
            if stream and flat:
                # the loop body holds NGSF_TG_D = 8 sites (the staged
                # kernel) or NGSF_UNROLL = 4 (a lane-per-thread kernel);
                # a transfer stream's of BC candidates, BC steps a site
                per = flat / (8 if staged else 4)
                bc = re.search(r"\(bool\)\d, \(int\)(\d+)>", nice)
                cands = (f" for {bc.group(1)} candidates"
                         if "k_transfer_stream" in nice and bc else "")
                floor = f"; {per:.1f} SASS instructions a site{cands} (the loop " \
                    f"body outside its nested loops), issue floor " + ", ".join(
                        f"{k} {per * v[1] / 32 / (4 * SM_COUNT * SM_CLOCK_MHZ * 1e3):.3f} ms"
                        for k, v in shapes.items())
            log(f"[probe build] {nice[:120]}: {p['regs']} registers, spills "
                f"{p.get('spill', (0, 0))}, smem {smem} B; "
                f"{ctas} CTAs of {threads} an SM ({waves}); {n_ins} SASS "
                f"instructions, loops: {top or 'none'}{floor}")


def probe_transcendentals():
    """The float64 operations of CUDA's exp and log as the package builds
    them (NVCC_FLAGS, -fmad=false): TRANSCENDENTAL_PROBE_CU to a cubin,
    cuobjdump -sass, and per function the DFMA (two operations), DADD and
    DMUL instructions, before the first EXIT (the path every finite input
    in range takes; the special-case branches laid out after it are
    counted apart). Sets FLOPS_LOG from those counts and returns them
    (exp, log). Fails the run if they cannot be read."""
    import re
    import shutil

    from ngsf_hmm_tpu_torch.utils import cuda_lib

    d = cuda_lib.build_dir() / "probe_build"
    d.mkdir(parents=True, exist_ok=True)
    src, cubin = d / "transcendentals.cu", d / "transcendentals.cubin"
    src.write_text(TRANSCENDENTAL_PROBE_CU)
    nvcc = cuda_lib._nvcc()
    r = subprocess.run([nvcc, *cuda_lib.NVCC_FLAGS, "-cubin", str(src),
                        "-o", str(cubin)], capture_output=True, text=True)
    if r.returncode:
        fail(f"probe_transcendentals: nvcc failed:\n{r.stderr}")
    dump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([dump, "-sass", str(cubin)], capture_output=True,
                          text=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), [{}, {}, False])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if cur is None or not m:
            continue
        op = re.sub(r"^@!?U?P\w+\s+", "", m.group(1).strip()).split()[0]
        key = op.split(".")[0]
        side = cur[1] if cur[2] else cur[0]
        side[key] = side.get(key, 0) + 1
        if key == "EXIT":
            cur[2] = True

    def ops(c):
        return 2 * c.get("DFMA", 0) + c.get("DADD", 0) + c.get("DMUL", 0)

    def ops32(c):
        return (2 * c.get("FFMA", 0) + c.get("FADD", 0) + c.get("FMUL", 0)
                + c.get("MUFU", 0))

    got = {}
    for fn, count, kind in (("probe_exp", ops, "float64"),
                            ("probe_log", ops, "float64"),
                            ("probe_expf", ops32, "float32"),
                            ("probe_logf", ops32, "float32")):
        if fn not in counts or not count(counts[fn][0]):
            fail(f"probe_transcendentals: no {kind} operations read for "
                 f"{fn} from the SASS")
        fast, rest, _ = counts[fn]
        got[fn] = count(fast)
        d = "D" if kind == "float64" else "F"
        log(f"[probe build] {fn[6:]} ({kind}): {count(fast)} operations to "
            f"the first EXIT ({d}FMA {fast.get(d + 'FMA', 0)}, {d}ADD "
            f"{fast.get(d + 'ADD', 0)}, {d}MUL {fast.get(d + 'MUL', 0)}; "
            f"MUFU {fast.get('MUFU', 0)}, {sum(fast.values())} "
            f"instructions), {count(rest)} more in the branches after it")
    FLOPS_LOG.update(flops_log(got["probe_exp"], got["probe_log"]))
    FLOPS_LOG32.update(flops_log(got["probe_expf"], got["probe_logf"]))
    log(f"[probe build] float64 operations a (site, column) of the scan "
        f"tier's kernels: {json.dumps(FLOPS_LOG)}; float32 (the float32 "
        f"instances): {json.dumps(FLOPS_LOG32)}")
    return got["probe_exp"], got["probe_log"]


_transfer_lib = []


def probe_lib():
    """TRANSFER_PROBE_CU built against the package's sources (once)."""
    import ctypes

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
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.window_probe.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.div_probe.argtypes = [ctypes.c_ulonglong, ctypes.c_longlong] + [
            ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        _transfer_lib.append(lib)
    return _transfer_lib[0]


def timed_split(label, name, timer, runs, nbytes, head=""):
    """Times each callable of `runs` twice, in turns (forward, then
    backward) and prints the least of each, with the bytes' rate where
    the name says "loads" or "bytes"."""
    ms = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            ms[k].append(timer(runs[k])[1])
    parts = []
    for k, ts in ms.items():
        t = min(ts)
        rate = (f", {nbytes / t / 1e9:.3f} TB/s"
                if "loads" in k or "bytes" in k else "")
        parts.append(f"{k} {t:.4f} ms{rate}")
    log(f"[{label}] {name} split{head}: " + "; ".join(parts))
    return {k: min(ts) for k, ts in ms.items()}


def probe_transfer(torch, timer, label, sl, F_t, a_t, v1):
    """The transfer-and-tangent kernel beside its two halves
    (TRANSFER_PROBE_CU) on the same slabs, in turns: the kernel, the step
    from registers (the product-rule step and the kernel's own), the
    loads alone (in the lane order, and the kernel's own staging); then
    the transfer kernel (B = 1) beside its own primal step from registers
    and the same loads alone; then the backward stream (bw_sites, from
    unit end vectors) beside its own step from registers and the same
    loads alone. Prints each time and the loads' rate. A measurement
    only: nothing is gated."""
    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
    from ngsf_hmm_tpu_torch.models import hmm_kernels_v1 as h1
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    lib = probe_lib()
    a, b = sl[0], sl[1]
    fc = None if v1 else sl[2]
    dc = sl[-1]
    bs, nb, N = a.shape
    source = 2 if v1 else (1 if a.dtype == torch.bfloat16 else 0)
    out = torch.empty(13 * nb * N, device=a.device)  # a kernel's output
    ends = torch.ones((2, nb, N), device=a.device)
    nbytes = 2 * a.numel() * a.element_size() + dc.numel() * 4 * (
        1 if v1 else 2)

    def probe(kind):
        return lambda: cuda_lib.check(lib.transfer_probe(
            kind, source, a.data_ptr(), b.data_ptr(),
            0 if fc is None else fc.data_ptr(), dc.data_ptr(),
            F_t.data_ptr(), a_t.data_ptr(), ends.data_ptr(), out.data_ptr(),
            bs, nb, N, cuda_lib.stream()), f"transfer_probe {kind}")

    def split(name, runs):
        timed_split(label, name, timer, runs, nbytes,
                    f" (lanes {nb * N}, bs {bs})")

    mod, sfx = (h1, "_v1") if v1 else (hk, "")
    grad = getattr(mod, "_k_block_transfer_grad" + sfx)
    tr = getattr(mod, "_k_block_transfer" + sfx)
    bw = getattr(mod, "_k_bw_sites" + sfx)
    F1, a1 = F_t[None].contiguous(), a_t[None].contiguous()
    lane_order = "loads alone, lane order, 4 sites in flight"
    split("transfer-and-tangent", {
        "kernel": lambda: grad(*sl, F_t, a_t),
        "step from registers (product rule)": probe(0),
        lane_order: probe(4),
        "step from registers (the kernel's own)": probe(1),
        "loads alone, the kernel's staging": probe(2)})
    split("transfer (block_transfer, B = 1)", {
        "kernel": lambda: tr(*sl, F1, a1),
        "step from registers (the kernel's own)": probe(7),
        lane_order: probe(4),
        "loads alone, the kernel's staging": probe(2)})
    split("backward stream (bw_sites)", {
        "kernel": lambda: bw(*sl, F_t, a_t, ends),
        "step from registers (the kernel's own)": probe(5),
        lane_order: probe(4),
        "loads alone, the kernel's staging": probe(6)})


def check_window_division(torch):
    """maf_window's quotient (div_rn_fast, the fast path of the IEEE
    division alone) against num / den on the card over 2^31 random pairs
    of positive floats with biased exponents in [96, 158), which covers
    the kernel's [NGSF_WIN_DIV_LO, NGSF_WIN_DIV_HI] = [2^-30, 2^30] with
    its ends; fails if one pair differs in any bit. Then 2^30 pairs in
    [2^-63, 2^64), for information."""
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    lib = probe_lib()
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    for elo, ehi, n, gate in ((96, 158, 1 << 31, True),
                              (64, 191, 1 << 30, False)):
        bad.zero_()
        cuda_lib.check(lib.div_probe(20_261_017 + elo, n, elo, ehi,
                                     bad.data_ptr(), cuda_lib.stream()),
                       "div_probe")
        n_bad = int(bad)
        log(f"[window division] div_rn_fast against num / den over {n} "
            f"random pairs, biased exponents [{elo}, {ehi}): {n_bad} differ")
        if gate and n_bad:
            fail(f"maf_window's div_rn_fast differs from num / den on "
                 f"{n_bad} pairs inside its range")


# maf_window's range for its fast quotient (csrc/maf_window.cu
# NGSF_WIN_DIV_LO, NGSF_WIN_DIV_HI)
WIN_DIV_RANGE = (2.0 ** -30, 2.0 ** 30)


def window_lane_steps(torch, st, grads, passes0, M):
    """(active lane-steps, lane-steps the warps run, sites that run their
    window again with the true division) of one window, on the plain
    version's arithmetic: the steps each site takes while active, 32 x
    each warp's longest (maf_window runs a thread a site, 32 consecutive
    sites a warp, and a warp issues until its last lane stops), and the
    active sites that fail the kernel's once-a-window test (a cn or cd of
    a step it ran with its sign bit set, or num, den outside WIN_DIV_RANGE
    at entry or exit)."""
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
    from ngsf_hmm_tpu_torch.utils.constants import ITER_MAX

    cn0, cd0, dcn, dcd = grads
    s = tuple(st)
    f0 = s[0]
    steps = torch.zeros_like(f0)
    neg = torch.zeros_like(f0, dtype=torch.bool)
    for k in range(M):
        steps += s[3]
        df = s[0] - f0
        cn, cd = cn0 + dcn * df, cd0 + dcd * df
        neg |= (s[3] != 0) & (torch.signbit(cn) | torch.signbit(cd))
        s = mk._advance_plain(s, cn, cd, passes0 + k + 1 <= ITER_MAX)
    lo, hi = WIN_DIV_RANGE
    inside = ((st[1] >= lo) & (st[2] >= lo) & (s[1] <= hi) & (s[2] <= hi))
    exact = (st[3] != 0) & (neg | ~inside)
    flat = steps.reshape(-1)
    warps = torch.nn.functional.pad(flat, (0, -flat.numel() % 32))
    return (float(flat.sum()),
            float(warps.reshape(-1, 32).amax(1).sum()) * 32,
            int(exact.sum()))


def probe_window(torch, timer, label, st, grads, passes0, M):
    """maf_window at one window, split in turns: the kernel; M = 0 (its
    bytes alone: the state copied, the gradients of the sites active at
    entry read); its steps from registers (TRANSFER_PROBE_CU's
    window_alone: the kernel's window_run on the inputs of the first
    65,536 sites, which stay in L2, nothing stored); then the active
    lane-steps against those the warps run (window_lane_steps). A
    measurement only: nothing is gated."""
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    lib = probe_lib()
    sites = st[0].numel()
    sub = min(sites, 65_536)
    st_s = st.reshape(4, -1)[:, :sub].contiguous()
    gr_s = grads.reshape(4, -1)[:, :sub].contiguous()
    sink = torch.zeros(1, device=st.device)
    act0 = float(st[3].sum())
    ms = timed_split(label, f"maf_window (M = {M})", timer, {
        "kernel": lambda: mk._k_maf_window(st, grads, passes0, M),
        "M = 0, bytes alone": lambda: mk._k_maf_window(st, grads, passes0,
                                                       0),
        "steps from registers": lambda: cuda_lib.check(lib.window_probe(
            st_s.data_ptr(), gr_s.data_ptr(), sink.data_ptr(), sites, sub,
            passes0, M, cuda_lib.stream()), "window_probe")},
        sites * 32 + act0 * 16, f" ({sites} sites)")
    act, run, exact = window_lane_steps(torch, st, grads, passes0, M)
    log(f"[{label}] maf_window (M = {M}) lane-steps: {act:.0f} active of "
        f"{run:.0f} the warps run ({act / run:.4f}); {act0:.0f} of {sites} "
        f"sites active at entry, {exact} of them run the window again with "
        f"the true division; the steps from registers "
        f"{ms['steps from registers'] * 1e9 / run:.4f} ps a lane-step run")


def probe_lanes(S, N, S_c, R=20):
    """(threads, cells) of a launch of each PROBE_SOURCES kernel: a lane
    per (block, column) for the stream kernels at the main path's shape
    and at the restart path's (R replicates of the check shape), G lanes
    a site for kernel A at the main path's shape; for maf_exact the exact
    path's shape (S_c x 20) and for maf_macro the main path's (float32 and
    bfloat16 slabs), each with its schedule (maf_probe_line); for
    maf_window the main path's sites and its longest window."""
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
    sums = dict(sites=bs * nb, N=N)
    window = dict(sites=bs * nb, M=max(macro_rounds(K0, M)))
    from ngsf_hmm_tpu_torch.models.hmm import log_geometry

    import torch

    scan = {}
    for name, dt in (("", torch.float64), (" float32", torch.float32)):
        scan["main" + name] = dict(S=S, C=N, N=N, float32=bool(name),
                                   nb=log_geometry(S, N, dt)[1])
        scan["restart" + name] = dict(S=S_c, C=R * N, N=N,
                                      float32=bool(name),
                                      nb=log_geometry(S_c, R * N, dt)[1])
    return {"log_chain.cu": scan, "maf_log.cu": scan,
            "block_transfer_grad.cu": stream, "block_transfer.cu": stream,
            "maf_window.cu": {"main": window},
            "bw_sites.cu": stream,
            "maf_state_grad.cu": {
                "main": (bs * nb * state_grad_geometry(N)[0], bs * nb * N)},
            "maf_sums_grad.cu": {"main": sums,
                                 "main bf16": dict(sums, bf16=True)},
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


def f64_anchor(torch, label, name, freq, g0, g2, p, macro, want=None):
    """The distance of an est_maf function's freq [S] from ops/maf.est_maf
    (linear, exact or macro=True) run in float64 on float64 copies of the
    linear gl planes g0 / g2 [S, N] and the posterior p [S, N] it read
    (snapped already where the function snaps): the largest and the mean
    absolute difference and the share of sites further than
    MAF_F64_STEP (stopped at another pass than float64). Logs and keeps
    them in ANCHORS; fails if a freq is further than MAF_FREQ_ATOL (a site
    that stops at another pass moves by one damped step, less than that).
    The share is information: it depends on the data. want: the float64
    freq of an earlier call on the same inputs. Returns the float64
    freq."""
    from ngsf_hmm_tpu_torch.ops import maf as tmaf

    d64 = torch.float64
    if want is None:
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
    return want


def anchor_exact(torch, label, gl_t, prep, p_sites, p_slab):
    """est_maf_exact (maf_exact, snapping the raw posterior slab) against
    float64 at the exact path's shape."""
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk
    from ngsf_hmm_tpu_torch.ops.hwe import check_interv

    g0, g2 = mk.gl_rows(gl_t)
    f64_anchor(torch, label, "est_maf_exact", mk.est_maf_exact(prep, p_slab),
               g0, g2, check_interv(p_sites), False)


def anchor_macro(torch, rows, p_m, prep, p_raw, slab_raw):
    """macro_slab (kernel 9) and est_maf_slab (kernel A, windows, kernel B)
    on main's float32 slabs and raw posterior slab, est_maf_slab also on
    bfloat16 slabs of the same gl (against float64 on the gl as those
    slabs hold it), and est_maf_rows (maf_macro on the LD path's rows and
    snapped posterior) against float64 at the main path's shape."""
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk

    g0, g2 = rows
    want = f64_anchor(torch, "main shape", "macro_slab", mk.macro_slab(
        prep, slab_raw), g0, g2, p_raw, True)
    f64_anchor(torch, "main shape", "est_maf_slab", mk.est_maf_slab(
        prep, slab_raw), g0, g2, p_raw, True, want=want)
    del want
    bf = torch.bfloat16
    prep_b = dict(prep, g0=prep["g0"].to(bf), g2=prep["g2"].to(bf))
    f64_anchor(torch, "main shape bf16", "est_maf_slab", mk.est_maf_slab(
        prep_b, slab_raw), g0.to(bf).float(), g2.to(bf).float(), p_raw, True)
    del prep_b
    f64_anchor(torch, "ld shape", "est_maf_rows", mk.est_maf_rows(g0, g2, p_m),
               g0, g2, p_m, True)


def check_maf_shapes(torch, dev, results, seed, S_m, Ns=(40, 32, 130, 300)):
    """The row est_maf kernel (maf_macro) and the slab est_maf kernels
    against their plain versions at S_m sites: a ragged site count at 40
    individuals, the schedule's edge (32), 130 and 300 (kernel A's G = 8,
    16 and 32 lanes a site; above 128 maf_macro recomputes its planes
    from cache, above 256 kernel A does; kernel B's G = 8, 16 and 32, its
    tiles staged); est_maf_slab's pieces and the one-launch slab kernel on
    float32 and bfloat16 slabs of the same gl. The LD path's shape is
    checked in main."""
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

    # ---- transfer, B = 1 (bit identity with the grad kernel), B = 2 (one
    # group of two candidates) and B = 3 (a ragged second group), each
    # bit-equal to its plain version on the card
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
    equal = [torch.equal(k4, p4)]
    F3 = torch.stack([F_t, F_t * 0.7, F_t * 0.4]).contiguous()
    a3 = torch.stack([a_t, a_t * 1.5, a_t * 0.5]).contiguous()
    for B in (2, 3):
        kb, pb = (kern["block_transfer"](*sl, F3[:B], a3[:B]),
                  plain["block_transfer"](*sl, F3[:B], a3[:B]))
        g, w = common_scale(kb[:4], pb[:4], kb[4], pb[4])
        err = max(err, float((g - w).abs().max()))
        equal.append(torch.equal(kb, pb))
        if not torch.equal(kb[:, 0], k4[:, 0]) and dev.type == "cuda":
            fail(f"[{label}] block_transfer{sfx}: candidate 0 of B = {B} "
                 "differs from B = 1")
    del pb
    if err > ATOL:
        fail(f"block_transfer{sfx} [{label}]: max diff {err} > {ATOL}")
    if dev.type == "cuda":
        if not all(equal):
            fail(f"block_transfer{sfx} [{label}]: not bit-equal to its "
                 f"plain version at B = 1, 2, 3: {equal}")
        log(f"[{label}] block_transfer{sfx} torch.equal its plain version at "
            "B = 1, 2 and 3: True")
    kb, F2 = kb[:, :2], F3[:2]  # two candidates for the combine below
    record("block_transfer" + sfx, err, ms, pms, src + 5 * nb * N * 4,
           flops("block_transfer"))
    del p4

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
    if err > ATOL or (dev.type == "cuda" and not torch.equal(bw_k, bw_p)):
        fail(f"bw_sites{sfx} [{label}]: not bit-equal to its plain version "
             f"(max diff {err})")
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


def check_offset_slabs(torch, label, v1, sl, F_t, a_t):
    """The staged stream kernels of one source (v1: the emission slabs'
    "_v1" exports, else the gl slabs'): the transfer-and-tangent kernel,
    the transfer kernel at B = 1 and B = 2 and bw_sites (from unit end
    vectors), on slabs that start one element into their storage (4-byte
    aligned float32, 2-byte aligned bfloat16 base addresses: the copy
    width must follow them, not the row length alone), each equal to its
    output on the aligned slabs bit for bit."""
    from ngsf_hmm_tpu_torch.models import hmm_kernels as hk
    from ngsf_hmm_tpu_torch.models import hmm_kernels_v1 as h1

    mod, sfx = (h1, "_v1") if v1 else (hk, "")
    bs, nb, N = sl[0].shape
    off = (offset_view(torch, sl[0]), offset_view(torch, sl[1])) + sl[2:]
    ends = torch.ones((2, nb, N), device=sl[0].device)
    F2 = torch.stack([F_t, F_t * 0.7]).contiguous()
    a2 = torch.stack([a_t, a_t * 1.5]).contiguous()
    runs = {
        "transfer-and-tangent kernel": (
            getattr(mod, "_k_block_transfer_grad" + sfx), (F_t, a_t)),
        "transfer kernel (B = 1)": (getattr(mod, "_k_block_transfer" + sfx),
                                    (F_t[None], a_t[None])),
        "transfer kernel (B = 2)": (getattr(mod, "_k_block_transfer" + sfx),
                                    (F2, a2)),
        "bw_sites": (getattr(mod, "_k_bw_sites" + sfx), (F_t, a_t, ends)),
    }
    for name, (kern, args) in runs.items():
        if not torch.equal(kern(*off, *args), kern(*sl, *args)):
            fail(f"[{label}] the {name} on offset slabs differs from its "
                 "output on aligned ones")
    log(f"[{label}] {', '.join(runs)} on slabs one element into their "
        "storage torch.equal the aligned ones: True")


def check_offset_sums_grad(torch, label, g0, g2, p, fq):
    """Kernel B on slabs that start one and two elements into their
    storage (its tiles then copied 4 or 8 bytes at a time on float32 gl,
    2 or 4 on bfloat16) equals its output on the aligned slabs (16-byte
    copies) bit for bit."""
    from ngsf_hmm_tpu_torch.ops import maf_kernels as mk

    want = mk._k_maf_sums_grad(g0, g2, p, fq)
    for k in (1, 2):
        got = mk._k_maf_sums_grad(offset_view(torch, g0, k),
                                  offset_view(torch, g2, k),
                                  offset_view(torch, p, k), fq)
        if not torch.equal(got, want):
            fail(f"[{label}] maf_sums_grad on slabs {k} elements into their "
                 "storage differs from its output on aligned ones")
    log(f"[{label}] maf_sums_grad on slabs 1 and 2 elements into their "
        "storage torch.equal the aligned ones: True")


def check_copy_widths(torch, dev, seed, S=3001):
    """The stream kernels of all three sources at S sites x 33 and 34
    columns: lanes odd and lanes = 2 mod 4, so the staged stream kernels
    (the transfer-and-tangent kernel, the transfer kernel, bw_sites) stage
    their rows with every copy width (16 and 8 bytes at the main and
    restart shapes; 8 and 4 bytes here for float32 rows, 4 and 2 for
    bfloat16 ones), with a partial last tile. Each kernel against its
    plain version (check_streams, the primal rows' bit identity included);
    then those three on slabs whose base addresses are not aligned to the
    row's width (check_offset_slabs), and
    kernel B on such slabs and the posterior slab (check_offset_sums_grad).
    Nothing is recorded."""
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
            po = check_streams(torch, dev, Recorder(torch, label, {}), timer,
                               label, sl, F_t, a_t, False)
            check_offset_slabs(torch, label, False, sl, F_t, a_t)
            check_offset_sums_grad(torch, label, prep["g0"], prep["g2"], po,
                                   sl[2].clamp(max=0.5))
        prep = h1.prepare_inputs(calc_emission(gl_t, freq_t[:, None]), dist_t)
        label = f"copy widths N={N} v1"
        sl = (prep["e0"], prep["e1"], prep["dc"])
        check_streams(torch, dev, Recorder(torch, label, {}), timer, label,
                      sl, F_t, a_t, True)
        check_offset_slabs(torch, label, True, sl, F_t, a_t)


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
            break  # the plain loop is some 15 s a variant at this size
    # bytes the function must move: the log emissions and distances in,
    # the int8 path out (its back-pointer scratch is the kernel's own)
    record("viterbi", err, ms, pms, S * N * (8 + 1) + S * 4 + N * 12,
           S * N * 40)


def log_err(torch, got, want):
    """Largest |got - want| / max(|want|, 1) over the finite entries; the
    non-finite ones (-inf log products) must match exactly."""
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin) or not torch.equal(
            got[~fin], want[~fin]):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    g, w = got[fin], want[fin]
    return float(((g - w).abs() / w.abs().clamp_min(1.0)).max())


def maf_log_passes(torch, gl, p):
    """The passes each site's log-space est_maf runs on these inputs (the
    plain loop of ops/maf.est_maf, recording when each site stops): the
    work maf_log's bound counts."""
    from ngsf_hmm_tpu_torch.ops.hwe import calc_hwe, post_prob
    from ngsf_hmm_tpu_torch.utils.constants import EPSILON, ITER_MAX

    S = gl.shape[0]
    dt = gl.dtype
    two_m_F = 2.0 - p
    T_w = two_m_F.sum(-1)
    freq = torch.full((S,), 0.01, dtype=dt, device=gl.device)
    num, den = torch.zeros_like(freq), torch.zeros_like(freq)
    active = torch.ones((S,), dtype=torch.bool, device=gl.device)
    passes = torch.zeros((S,), dtype=torch.int64, device=gl.device)
    k = 0
    while bool(active.any()):
        pp = torch.exp(post_prob(gl, calc_hwe(freq[:, None], p)))
        cn = (pp[..., 1] + pp[..., 2] * two_m_F).sum(-1)
        cd = T_w + (pp[..., 1] * p).sum(-1)
        prev = freq
        num = torch.where(active, num + cn, num)
        den = torch.where(active, den + cd, den)
        freq = torch.where(active, num / den, freq)
        k += 1
        passes += active.long()
        active = active & ((prev - freq).abs() > EPSILON) & (k <= ITER_MAX)
    return passes


def maf_log_warp_passes(torch, passes, N):
    """The passes maf_log's warps run for these sites' `passes`, and the
    sites a warp: a warp holds 32 / G consecutive sites (maf_log_launch)
    and runs until its last one stops, so every site of it runs as
    many."""
    from ngsf_hmm_tpu_torch.ops.maf import maf_log_launch

    spw = 32 // maf_log_launch(N, 8)[0]
    S = passes.numel()
    pad = torch.zeros((-S) % spw, dtype=passes.dtype, device=passes.device)
    per = torch.cat([passes, pad]).view(-1, spw)
    n = torch.cat([torch.ones_like(passes), pad]).view(-1, spw).sum(1)
    return int((per.max(1).values * n).sum()), spw


def check_maf_log(torch, label, gl_t, ps, rec=None, timer=None):
    """maf_log (csrc/maf_log.cu) against its plain version on gl_t [S, N,
    3] and the snapped posterior ps [S, N] (a view with strided rows is
    read in place), float64: freq relative LOG_MAF_RTOL except at sites
    that stop at another pass (at most MAF_FLIP_SHARE of them, within
    MAF_FREQ_ATOL); then the float32 instance against its plain version
    (MAF_RTOL, MAF_FLIP_SHARE, MAF_FREQ_ATOL). With rec: timed beside its
    bound, counted from the passes this data needs (maf_log_passes) and
    its cells whose F is neither 0 nor 1 (maf_log_cell, _own, _site);
    prints the passes the warps run against those needed and the share of
    such cells. Returns (freq, the largest relative
    difference at the sites that stop at the same pass)."""
    from ngsf_hmm_tpu_torch.ops import maf as tmaf

    S, N = gl_t.shape[0], gl_t.shape[1]
    G = tmaf.maf_log_geometry(N)[0]
    if rec is not None:
        f_k, ms = timer(lambda: tmaf.est_maf(gl_t, ps))
        f_p, pms = timer(lambda: tmaf._est_maf_plain(gl_t, ps), reps=1,
                         warm=0)
    else:
        f_k, f_p = tmaf.est_maf(gl_t, ps), tmaf._est_maf_plain(gl_t, ps)
    name = "maf_log"
    if rec is not None:
        rec.finite(name, f_k, f_p)
    rel = (f_k - f_p).abs() / f_p.abs()
    off = rel > LOG_MAF_RTOL
    share = float(off.double().mean())
    d_off = float((f_k - f_p)[off].abs().max()) if bool(off.any()) else 0.0
    err = float(rel[~off].max()) if not bool(off.all()) else float("inf")
    log(f"[{label}] maf_log (N={N}, G={G}): freq max rel diff {err:.3g} "
        f"where the pass agrees, sites stopping at another pass {share:.3g} "
        f"of {S}, their freq max diff {d_off:.3g}")
    if share > MAF_FLIP_SHARE or d_off > MAF_FREQ_ATOL:
        fail(f"maf_log [{label}]: {share} of the sites off the plain "
             f"version, by up to {d_off}")
    if rec is not None:
        passes = maf_log_passes(torch, gl_t, ps)
        own = ((ps != 0) & (ps != 1)).sum(1)
        flops = int((passes * (N * FLOPS_LOG["maf_log_cell"]
                               + own * FLOPS_LOG["maf_log_own"]
                               + FLOPS_LOG["maf_log_site"])).sum())
        rec.record(name, err, ms, pms, S * N * 32 + S * 8, flops,
                   peak=PEAK_F64)
        run, spw = maf_log_warp_passes(torch, passes, N)
        need = int(passes.sum())
        log(f"[{label}] maf_log: passes a site min {int(passes.min())}, "
            f"mean {float(passes.double().mean()):.2f}, max "
            f"{int(passes.max())}; the warps run {run} site-passes for "
            f"{need} needed ({run / need:.4f}x, {spw} sites a warp); cells "
            f"whose F is neither 0 nor 1 (their own prior logs) "
            f"{float(own.sum()) / (S * N):.4f}")
    f32 = torch.float32
    f_k32 = tmaf.est_maf(gl_t.to(f32), ps.to(f32))
    f_p32 = tmaf._est_maf_plain(gl_t.to(f32), ps.to(f32))
    rel32 = (f_k32 - f_p32).abs() / f_p32.abs()
    share32 = float((rel32 > MAF_RTOL).double().mean())
    d32 = float((f_k32 - f_p32).abs().max())
    log(f"[{label}] maf_log float32 (N={N}): sites off by more than "
        f"{MAF_RTOL} {share32:.3g}, freq max diff {d32:.3g}")
    if share32 > MAF_FLIP_SHARE or d32 > MAF_FREQ_ATOL:
        fail(f"maf_log float32 [{label}]: {share32} of the sites off, by "
             f"up to {d32}")
    return f_k, err


# maf_log's shapes beyond the paths': one for each segment width G that
# maf_log_geometry chooses (N = 3, 9, 20, 33, 100, 130, 1,000: G = 1, 2,
# 4, 4, 8, 16, 32), and N = 4,000, whose cells are read from device
# memory every pass (maf_log_launch)
MAF_LOG_NS = ((3, 33_333), (9, 33_333), (20, 33_333), (33, 33_333),
              (100, 33_333), (130, 33_333), (1_000, 10_007), (4_000, 1_001))


def check_maf_log_shapes(torch, dev, seed, results, Ns=MAF_LOG_NS):
    """maf_log against its plain version (check_maf_log, float64 and
    float32) at each (N, S) of Ns, on the snapped posterior the scan
    tier's chain gives for simulated data; the kernel's line keeps the
    largest error."""
    from ngsf_hmm_tpu_torch.models import hmm as thmm
    from ngsf_hmm_tpu_torch.ops.emissions import calc_emission
    from ngsf_hmm_tpu_torch.ops.hwe import check_interv

    f64 = torch.float64
    for i, (N, S) in enumerate(Ns):
        gl, dist, freq, F0, a0 = simulate(S, N, seed + i)
        gl_t = torch.as_tensor(gl).to(dev).to(f64)
        e = calc_emission(gl_t, torch.as_tensor(freq).to(dev, f64)[:, None])
        p, _, _ = thmm.posteriors(e, torch.as_tensor(dist).to(dev, f64),
                                  torch.as_tensor(F0).to(dev, f64),
                                  torch.as_tensor(a0).to(dev, f64))
        del e
        _, err = check_maf_log(torch, f"maf_log shape {S}x{N}", gl_t,
                               check_interv(p))
        r = results.setdefault("maf_log", {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        del gl_t, p


# log_sum2 / log_sum3 of csrc/log_common.cuh (the maximum term taken as 1)
# beside the forms with an exp for every term, float64 and float32, on
# the card (check_logsum_identity)
LOGSUM_CHECK_CU = r"""
#include "log_common.cuh"
template <typename T> __device__ T exp_sum2(T a, T b) {
    const T m = lc_max(a, b);
    if (m == (T)-INFINITY) return (T)-INFINITY;
    return lc_log(lc_exp(a - m) + lc_exp(b - m)) + m;
}
template <typename T> __device__ T exp_sum3(T a, T b, T c) {
    const T m = lc_max(lc_max(a, b), c);
    if (m == (T)-INFINITY) return (T)-INFINITY;
    return lc_log((lc_exp(a - m) + lc_exp(b - m)) + lc_exp(c - m)) + m;
}
template <typename T>
__global__ void k_check(const T* x, T* out, long long n) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const T a = x[3 * i], b = x[3 * i + 1], c = x[3 * i + 2];
    out[4 * i] = exp_sum2(a, b);
    out[4 * i + 1] = log_sum2(a, b);
    out[4 * i + 2] = exp_sum3(a, b, c);
    out[4 * i + 3] = log_sum3(a, b, c);
}
__global__ void k_exp0(double* d, float* f) {
    const double zd[2] = {0.0, -0.0};
    const float zf[2] = {0.0f, -0.0f};
    d[threadIdx.x] = exp(zd[threadIdx.x]);
    f[threadIdx.x] = expf(zf[threadIdx.x]);
}
extern "C" int logsum_check(const void* x, void* out, long long n, int f64,
                            void* st) {
    const unsigned g = (unsigned)((n + 255) / 256);
    if (f64)
        k_check<double><<<g, 256, 0, (cudaStream_t)st>>>(
            (const double*)x, (double*)out, n);
    else
        k_check<float><<<g, 256, 0, (cudaStream_t)st>>>(
            (const float*)x, (float*)out, n);
    return (int)cudaGetLastError();
}
extern "C" int exp_zero(double* d, float* f, void* st) {
    k_exp0<<<1, 2, 0, (cudaStream_t)st>>>(d, f);
    return (int)cudaGetLastError();
}
"""


def logsum_inputs(torch, n, seed):
    """[rows, 3] float64 arguments: every triple of the edge values
    (zeros of both signs, +-1, +-inf, NaN, the least subnormal, exp's
    ends, the largest float64 and float32), ties, then n random triples
    at gaps from 1e-12 to 1e3 (and some far apart)."""
    edge = torch.tensor([0.0, -0.0, 1.0, -1.0, float("inf"), -float("inf"),
                         float("nan"), 5e-324, -745.2, 709.8, 1.7e308,
                         -1.7e308, 3.4e38, -103.9], dtype=torch.float64)
    k = edge.numel()
    idx = torch.stack(torch.meshgrid(*(torch.arange(k),) * 3,
                                     indexing="ij"), -1).reshape(-1, 3)
    g = torch.Generator().manual_seed(seed)
    base = torch.randn(n, 1, generator=g, dtype=torch.float64) * 50
    gap = torch.randn(n, 3, generator=g, dtype=torch.float64) * 10.0 ** (
        torch.randint(-12, 4, (n, 3), generator=g).double())
    x = base + gap
    x[: n // 8, 1] = x[: n // 8, 0]  # ties
    x[n // 8: n // 4, 2] = x[n // 8: n // 4, 0] - 1e6  # one far below
    return torch.cat([edge[idx], x])


def bits_equal(torch, a, b):
    """NaN where the other is NaN, every other entry the same bits (so
    -0.0 and +0.0 differ)."""
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ib = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a[~nan].view(ib), b[~nan].view(ib))


def check_logsum_identity(torch, n=1 << 22):
    """On the card: exp(+-0.0) is 1.0 exactly (float64 and float32), and
    log_sum2 / log_sum3 of csrc/log_common.cuh (the maximum term's exp
    taken as 1) give the bits of the forms with an exp for every term on
    every edge triple and on n random ones, in float64 and float32 (the
    float32 arguments rounded from the float64 ones). Fails otherwise."""
    import ctypes

    from ngsf_hmm_tpu_torch.utils import cuda_lib

    d = cuda_lib.build_dir()
    d.mkdir(parents=True, exist_ok=True)
    src, so = d / "logsum_check.cu", d / "logsum_check.so"
    src.write_text(LOGSUM_CHECK_CU)
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-I",
                    str(cuda_lib.CSRC), str(src), "-o", str(so)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.logsum_check.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.exp_zero.argtypes = [ctypes.c_void_p] * 3
    dev = torch.device("cuda")
    e_d = torch.empty(2, dtype=torch.float64, device=dev)
    e_f = torch.empty(2, dtype=torch.float32, device=dev)
    cuda_lib.check(lib.exp_zero(e_d.data_ptr(), e_f.data_ptr(),
                                cuda_lib.stream()), "exp_zero")
    ok = bool((e_d == 1.0).all()) and bool((e_f == 1.0).all())
    x64 = logsum_inputs(torch, n, 29).to(dev)
    rows = x64.shape[0]
    same = {}
    for name, x in (("float64", x64), ("float32", x64.float())):
        out = torch.empty((rows, 4), dtype=x.dtype, device=dev)
        cuda_lib.check(lib.logsum_check(x.data_ptr(), out.data_ptr(), rows,
                                        int(x.dtype == torch.float64),
                                        cuda_lib.stream()), "logsum_check")
        same[name] = (bits_equal(torch, out[:, 0], out[:, 1]),
                      bits_equal(torch, out[:, 2], out[:, 3]))
    log(f"[logsum identity] exp(+-0.0) on the card: float64 "
        f"{e_d.tolist()}, float32 {e_f.tolist()}; one-exp logsum2 / "
        f"logsum3 bit-equal to the all-exp forms on {rows} triples "
        f"(edge values, ties, random gaps): {same}")
    if not ok or not all(all(v) for v in same.values()):
        fail("the one-exp logsum forms differ from the all-exp forms")


# --scan-times holds this many posterior rows, drawn from this seed, to
# the reference run's
SCAN_P_ROWS, SCAN_P_SEED = 512, 1234
# the scan tier's kernels that --before times, in this order
SCAN_TIMED = ("log_block_transfer", "log_combine", "log_sweep (grad)",
              "log_sweep (posterior)", "maf_log")


def walk_error(torch, A, F, walks):
    """The largest distance of log_combine's four outputs (walks: fw_in,
    bw_out, ll_f, ll_b) from the same walks over the same block products
    A [nb, C, 2, 2], run serially from the same float64 log q in numpy's
    long double (a 64-bit mantissa on x86): absolute over the finite
    entries, inf where the two disagree on which entries are -inf."""
    from ngsf_hmm_tpu_torch.models.hmm import log_q

    ld = np.longdouble
    if np.finfo(ld).eps > 1e-18:
        fail("walk_error: numpy's long double is no wider than float64")
    a = A.cpu().numpy().astype(ld)
    lq = log_q(F).cpu().numpy().astype(ld)
    nb = a.shape[0]
    fw, bw = (np.empty(a.shape[:2] + (2,), ld) for _ in range(2))
    v0, v1 = lq[:, 0], lq[:, 1]
    w0 = w1 = np.zeros_like(v0)
    for j in range(nb):
        fw[j, :, 0], fw[j, :, 1] = v0, v1
        v0, v1 = (np.logaddexp(v0 + a[j, :, 0, 0], v1 + a[j, :, 1, 0]),
                  np.logaddexp(v0 + a[j, :, 0, 1], v1 + a[j, :, 1, 1]))
        q = nb - 1 - j
        bw[q, :, 0], bw[q, :, 1] = w0, w1
        w0, w1 = (np.logaddexp(a[q, :, 0, 0] + w0, a[q, :, 0, 1] + w1),
                  np.logaddexp(a[q, :, 1, 0] + w0, a[q, :, 1, 1] + w1))
    exact = (fw, bw, np.logaddexp(v0, v1),
             np.logaddexp(w0 + lq[:, 0], w1 + lq[:, 1]))
    err = 0.0
    for got, ex in zip(walks, exact):
        g, fin = got.cpu().numpy().astype(ld), np.isfinite(ex)
        if not np.array_equal(np.isfinite(g), fin):
            return float("inf")
        if fin.any():
            err = max(err, float(np.abs(g[fin] - ex[fin]).max()))
    return err


def scan_diff(torch, name, pairs):
    """The largest difference of --scan-times output pairs (got, want):
    absolute for the posterior rows, log_err for the others."""
    if name == "log_sweep (posterior)":
        return max(float((g - w).abs().max()) for g, w in pairs)
    return max(log_err(torch, g, w) for g, w in pairs)


def scan_time_shape(torch, label, chain, gl_t, N, ref, out):
    """One shape of --scan-times: the scan tier's kernels through the
    package's wrappers at its own log_geometry, each timed (Timer: the mean
    of 3 calls after a warm-up), their outputs written under out (the
    block products, the walks' four outputs, the grad sweep's block sums
    and SCAN_P_ROWS seeded rows of the posterior, whole 0.8 GB at the
    scan shape); with a reference run, the chain's three kernels once
    more, untimed, at its geometry, each kernel's outputs held to its
    files on its inputs at the gates of the kernels against their plain
    versions (two trees' chain kernels need not give the same bits): the
    block products and the walks at LOG_RTOL, the sweep run on the
    reference's walks at LOG_G_RTOL and LOG_P_ATOL. Each tree's walks are
    also held to the same walks over its own block products in long
    double (walk_error): this tree's may sit no farther from them than the
    reference's. The sweep on this tree's own walks is held to the
    reference's at an ulp of max |ll_f| a serial step of a walk (nb) and
    of a block (bs): where |ll_f| is about 8e5 an ulp of the walks' log
    values is 1.2e-10, and another association of their sums moves them,
    and the posterior and the gradient with them, by tens of ulps, above
    the 1e-9 gates. Then maf_log on the last N columns of the snapped
    posterior (a strided view where the columns hold several replicates),
    the posterior of the reference's walks where there is one, its freq
    held to the reference's inside the maf_log gates. Returns this shape's record (geometry, times); writes the
    outputs and maf_log's freq under out."""
    from ngsf_hmm_tpu_torch.models import hmm as thmm
    from ngsf_hmm_tpu_torch.ops import maf as tmaf
    from ngsf_hmm_tpu_torch.ops.hwe import check_interv
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    e, dist_t, F_t, a_t = chain
    timer = Timer(torch, e.device)
    S, C = e.shape[0], e.shape[1]
    rows = torch.randperm(S, generator=torch.Generator().manual_seed(
        SCAN_P_SEED))[:SCAN_P_ROWS].sort().values.to(e.device)

    def run(bs, nb, timed):
        t = timer if timed else (lambda fn: (fn(), None))
        o, ms = {}, {}
        A, ms["log_block_transfer"] = t(
            lambda: thmm.log_block_transfer(*chain, bs, nb))
        c, ms["log_combine"] = t(lambda: thmm.log_combine(A, F_t))
        o["log_block_transfer"] = [A]
        o["log_combine"] = list(c)
        for grad in (True, False):
            name = "log_sweep (grad)" if grad else "log_sweep (posterior)"
            r, ms[name] = t(lambda: thmm.log_sweep(*chain, *c[:3], bs,
                                                   grad=grad))
            o[name] = [r if grad else r[rows]]
        return o, ms, r

    cuda_lib.LAUNCHES.clear()
    geom = list(thmm.log_geometry(S, C))
    outs, ms, p = run(*geom, timed=True)
    torch.save({k: [x.cpu() for x in v] for k, v in outs.items()},
               out / f"{label}_chain.pt")
    if ref is not None:
        geom_r = ref["geometry"]
        got, _, _ = run(*geom_r, timed=False)
        want = {k: [w.to(e.device) for w in v] for k, v in torch.load(
            ref["dir"] / f"{label}_chain.pt").items()}
        # the sweep once more on the reference's walks: each kernel is
        # held to the reference on the reference's inputs, and maf_log
        # reads that posterior
        fw_r, bw_r, llf_r = want["log_combine"][:3]
        g_r = thmm.log_sweep(*chain, fw_r, bw_r, llf_r, geom_r[0],
                             grad=True)
        p = thmm.log_sweep(*chain, fw_r, bw_r, llf_r, geom_r[0])
        on_ref = {"log_sweep (grad)": [g_r],
                  "log_sweep (posterior)": [p[rows]]}
        held = {k: (got[k] if "sweep" not in k else on_ref[k])
                for k in got}
        errs, same, bad = {}, {}, []
        for k, ts in held.items():
            pairs = list(zip(ts, want[k]))
            same[k] = all(bits_equal(torch, g, w) for g, w in pairs)
            errs[k] = scan_diff(torch, k, pairs)
            tol = (LOG_P_ATOL if k == "log_sweep (posterior)" else
                   LOG_G_RTOL if "grad" in k else LOG_RTOL)
            if not errs[k] <= tol:
                bad.append(k)
        ulp = float(np.spacing(float(llf_r.abs().max())))
        walk = [walk_error(torch, o["log_block_transfer"][0], F_t,
                           o["log_combine"]) for o in (got, want)]
        if not walk[0] <= walk[1]:
            bad.append("log_combine (long double walks)")
        own_tol = (geom_r[0] + geom_r[1]) * ulp
        own = {k: scan_diff(torch, k, list(zip(got[k], want[k])))
               for k in on_ref}
        bad += [k + " (own walks)" for k, v in own.items()
                if not v <= own_tol]
        log(f"[scan times {label}] this tree's chain kernels at the "
            f"reference's geometry bs={geom_r[0]} nb={geom_r[1]} against "
            f"its outputs (the sweep on its walks): max diff "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; bit-equal {same}; the walks from the long double walks "
            f"over each tree's block products: this {walk[0]:.4g} "
            f"({walk[0] / ulp:.1f} ulp of max |ll_f|, {ulp:.3g}), the "
            f"reference {walk[1]:.4g} ({walk[1] / ulp:.1f} ulp); the sweep "
            "on this tree's own walks: "
            + ", ".join(f"{k} {v:.3g}" for k, v in own.items())
            + f" (limit (bs + nb) ulp = {own_tol:.3g})")
        if bad:
            fail(f"[scan times {label}] {bad} off the reference run's "
                 "outputs")
    ps = check_interv(p)[:, C - N:]
    f, ms["maf_log"] = timer(lambda: tmaf.est_maf(gl_t, ps))
    missing = [k for k in ("log_block_transfer", "log_combine", "log_sweep",
                           "maf_log") if not cuda_lib.LAUNCHES[k]]
    if e.is_cuda and missing:
        fail(f"[scan times {label}] no launch of {missing}")
    torch.save(f.cpu(), out / f"{label}_freq.pt")
    if ref is not None:
        f_r = torch.load(ref["dir"] / f"{label}_freq.pt").to(f.device)
        rel = (f - f_r).abs() / f_r.abs()
        off = rel > LOG_MAF_RTOL
        d_off = float((f - f_r)[off].abs().max()) if bool(off.any()) else 0.0
        log(f"[scan times {label}] maf_log against the reference's freq: "
            f"bit-equal {torch.equal(f, f_r)}, sites differing "
            f"{int((f != f_r).sum())} of {S}, max rel diff "
            f"{float(rel[~off].max()) if not bool(off.all()) else 0.0:.3g} "
            f"where the pass agrees, sites stopping at another pass "
            f"{int(off.sum())} (freq max diff {d_off:.3g})")
        if (float(off.double().mean()) > MAF_FLIP_SHARE
                or d_off > MAF_FREQ_ATOL):
            fail(f"[scan times {label}] maf_log off the reference's")
    log(f"[scan times {label}] S={S} columns={C} bs={geom[0]} "
        f"nb={geom[1]}: " + ", ".join(f"{k} {v:.3f} ms"
                                      for k, v in ms.items()))
    return {"geometry": geom, "ms": ms}


def run_scan_times(torch, dev, args, R=20):
    """--scan-times OUT: scan_time_shape on the package's kernels (this
    tree's, or --tree's) at the scan path's shape (the main data in
    float64) and the scan_restart path's (R replicates of the check
    shape's data, R * N columns); with --against-times REF, against that
    run's files. Writes OUT/times.json. Prints no result and returns 4."""
    import pathlib

    from ngsf_hmm_tpu_torch.models.restart import (flatten_states,
                                                   stack_restart_states)
    from ngsf_hmm_tpu_torch.ops.emissions import calc_emission

    out = pathlib.Path(args.scan_times)
    out.mkdir(parents=True, exist_ok=True)
    refs = {}
    if args.against_times:
        ref_dir = pathlib.Path(args.against_times)
        refs = json.loads((ref_dir / "times.json").read_text())
        for r in refs.values():
            r["dir"] = ref_dir
    f64 = torch.float64
    recs = {}
    gl, dist, freq, F0, a0 = simulate(args.sites, args.ind, args.seed)
    gl_t = torch.as_tensor(gl).to(dev).to(f64)
    del gl
    e = calc_emission(gl_t, torch.as_tensor(freq).to(dev, f64)[:, None])
    chain = (e, torch.as_tensor(dist).to(dev, f64),
             torch.as_tensor(F0).to(dev, f64),
             torch.as_tensor(a0).to(dev, f64))
    recs["scan"] = scan_time_shape(torch, "scan", chain, gl_t, args.ind,
                                   refs.get("scan"), out)
    del e, chain, gl_t
    gl_c, dist_c, _, _, _ = simulate(args.check_sites, args.ind,
                                     args.seed + 7, n_chrom=1)
    step = max(2, min(100_000, args.check_sites // 2))
    dist_c[step::step] = np.inf  # as main() makes the restart path's data
    gl_t = torch.as_tensor(gl_c).to(dev).to(f64)
    flat = flatten_states(stack_restart_states(gl_t, R, args.seed + 5,
                                               device=dev))
    chain = (flat.e_prob, torch.as_tensor(dist_c).to(dev, f64),
             flat.indF.to(f64).contiguous(), flat.alpha.to(f64).contiguous())
    recs["scan_restart"] = scan_time_shape(
        torch, "scan_restart", chain, gl_t, args.ind,
        refs.get("scan_restart"), out)
    (out / "times.json").write_text(json.dumps(recs))
    return 4


def compare_trees(args):
    """--before DIR: run_scan_times in four processes, in turns on DIR's
    package (another tree's, the parent's) and this tree's: DIR, this,
    this, DIR, each but the first against the first's files; then prints
    for each shape and kernel the mean of each tree's two runs and their
    ratio. Each tree runs its own wrappers and geometry, so nothing of the
    other tree's interface is copied here. Returns 4 (no result)."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent / "build" / "scan_times"
    flags = ["--sites", str(args.sites), "--ind", str(args.ind),
             "--check-sites", str(args.check_sites), "--seed",
             str(args.seed)] + (["--rehearse"] if args.rehearse else [])
    other = ["--tree", os.path.abspath(args.before)]
    runs = (("other", other), ("this", []), ("this", []), ("other", other))
    times = {"other": [], "this": []}
    for i, (who, extra) in enumerate(runs):
        out = root / f"{i}_{who}"
        against = ["--against-times", str(root / "0_other")] if i else []
        log(f"[before] run {i}: the {who} tree")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--scan-times", str(out), *extra, *against,
                             *flags]).returncode
        if rc != 4:
            fail(f"--before: run {i} (the {who} tree) exited {rc}")
        times[who].append(json.loads((out / "times.json").read_text()))
    for shape in times["this"][0]:
        for k in SCAN_TIMED:
            o = [t[shape]["ms"][k] for t in times["other"]]
            m = [t[shape]["ms"][k] for t in times["this"]]
            mo, mm = sum(o) / len(o), sum(m) / len(m)
            log(f"[before {shape}] {k}: other tree {mo:.3f} ms ({o[0]:.3f}, "
                f"{o[1]:.3f}), this tree {mm:.3f} ms ({m[0]:.3f}, "
                f"{m[1]:.3f}): {mm / mo:.3f}x")
    log("before: done; no result is printed for it")
    return 4


def same_log_bits(torch, what, got, want):
    """A chain kernel's outputs (a tensor or a tuple) against its plain
    version's: every entry the same bits, or the run fails. Returns the
    largest log_err (0 where the bits agree), for the kernels' line."""
    got = (got,) if torch.is_tensor(got) else tuple(got)
    want = (want,) if torch.is_tensor(want) else tuple(want)
    err = max(log_err(torch, a, b) for a, b in zip(got, want))
    same = all(bits_equal(torch, a, b) for a, b in zip(got, want))
    log(f"[bits] {what}: bit-equal to the plain version {same} (max diff "
        f"{err:.3g})")
    if not same:
        fail(f"{what}: not the plain version's bits (max diff {err:.3g})")
    return err


def extreme_chain(torch, dev, S, N, seed):
    """float64 chain inputs at the edges of the linear block product
    (tests/test_torch_log_kernels.py's cases at a larger size): columns
    with F = 0, 1 and 1e-300, a column whose decay at one site is exp(-720)
    (subnormal), columns whose two states' emissions stay 25 nats apart at
    every site (so a block's row entries drift thousands of nats apart),
    -inf emissions of one state (runs of sites) and of both (one site of
    one column), one site of 800 nats' emission gap a column, chromosome
    breaks and runs of sites at distance 0."""
    rng = np.random.default_rng(seed)
    e = np.log(rng.uniform(1e-5, 1.0, (S, N, 2)))
    dist = rng.uniform(0.001, 0.3, S)
    dist[0] = 1.5
    dist[S // 3::S // 3] = np.inf
    dist[100:140] = 0.0
    F = rng.uniform(0.05, 0.9, N)
    alpha = rng.uniform(0.01, 0.5, N)
    F[:3] = (0.0, 1.0, 1e-300)
    alpha[1] = 360.0
    dist[S // 2] = 2.0  # column 1: x = exp(-720)
    for c in range(4, 10):
        k = c % 2
        e[:, c, 1 - k] = e[:, c, k] - 25.0
    F[4:10:2], F[5:10:2] = 0.0, 1.0
    e[1000:1050, 10, 1] = -np.inf
    e[2000:2010, 11, 0] = -np.inf
    e[S // 4, 12, :] = -np.inf
    cols = np.arange(13, N)
    e[rng.integers(0, S, cols.size), cols, 0] -= 800.0
    t = lambda x: torch.as_tensor(x).to(dev, torch.float64)
    return t(e), t(dist), t(F), t(alpha)


def check_log_extremes(torch, dev, seed, S=20_011, N=40):
    """log_block_transfer and log_combine bit-equal to their plain
    versions on extreme_chain's inputs, at log_geometry's blocks and at
    blocks of 1,200 sites; log_combine also at chunk length 1 (where its
    chunks fit a CTA) and nb. Prints the widest gap between a row's two
    finite entries of A (the linear product keeps them apart however far
    they drift)."""
    from ngsf_hmm_tpu_torch.models import hmm as thmm
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    chain = extreme_chain(torch, dev, S, N, seed)
    F_t = chain[2]
    for bs, nb in (thmm.log_geometry(S, N), (1_200, -(-S // 1_200))):
        what = f"extreme shape S={S} columns={N} bs={bs} nb={nb}"
        A = thmm.log_block_transfer(*chain, bs, nb)
        same_log_bits(torch, f"log_block_transfer [{what}]", A,
                      thmm._log_block_transfer_plain(*chain, bs, nb))
        lens = [thmm.log_combine_chunk_len(nb), nb] + (
            [1] if nb <= cuda_lib.LOG_COMBINE_MAX_CHUNKS else [])
        for L in lens:
            same_log_bits(torch, f"log_combine [{what}] L={L}",
                          thmm._log_combine(A, F_t, L),
                          thmm._log_combine_plain(A, F_t, L))
        fin = torch.isfinite(A[..., 0]) & torch.isfinite(A[..., 1])
        gap = (A[..., 0] - A[..., 1]).abs()[fin]
        log(f"[{what}] -inf entries of A {int(torch.isneginf(A).sum())} "
            f"of {A.numel()}, widest gap between a row's finite entries "
            f"{float(gap.max()):.1f} nats")


def check_log_kernels(torch, dev, gl, dist, freq, F, alpha, label, results,
                      oracle=False, e_prob=None, chunks=()):
    """The scan tier's kernels (csrc/log_chain.cu, csrc/maf_log.cu) against
    their plain versions on `dev`, float64, at this shape: the emissions of
    (gl, freq), the chain's three kernels (the sweep in both modes), then
    maf_log on the chain's snapped posterior, also on a replicate's
    strided columns and in its float32 instantiation; each timed beside
    its bound (float64 operations over PEAK_F64, or bytes). e_prob: the
    chain's emissions [S, C, 2] in place of (gl, freq)'s, with F and alpha
    of its C columns: R = C / N replicates flattened into the columns, as
    the scan_restart path runs them (the chain over all C columns, then
    maf_log on the last replicate's strided columns, read in place).
    oracle=True (a small shape): also the public chain functions against
    the per-site oracle loops of models/hmm.py and float64 Viterbi against
    its plain version. chunks: log_combine also at these chunk lengths.
    log_block_transfer and log_combine must give their plain versions'
    bits. Fails the run on any disagreement."""
    from ngsf_hmm_tpu_torch.models import hmm as thmm
    from ngsf_hmm_tpu_torch.ops import maf as tmaf
    from ngsf_hmm_tpu_torch.ops.emissions import calc_emission
    from ngsf_hmm_tpu_torch.ops.hwe import check_interv
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    timer = Timer(torch, dev)
    f64 = torch.float64
    S, N = gl.shape[0], gl.shape[1]
    gl_t = torch.as_tensor(gl).to(dev).to(f64)
    dist_t = torch.as_tensor(dist).to(dev, f64)
    F_t = torch.as_tensor(F).to(dev, f64)
    a_t = torch.as_tensor(alpha).to(dev, f64)
    e = (calc_emission(gl_t, torch.as_tensor(freq).to(dev, f64)[:, None])
         if e_prob is None else e_prob)
    C = e.shape[1]
    bs, nb = thmm.log_geometry(S, C)
    log(f"[{label}] scan tier: S={S} columns={C} float64 bs={bs} nb={nb} "
        f"lanes={nb * C} pad sites={nb * bs - S} "
        f"breaks={int(np.isinf(dist).sum())}")
    rec = Recorder(torch, label, results)
    chain = (e, dist_t, F_t, a_t)
    e_bytes = S * C * 16 + S * 8 + C * 16

    def gate(name, err, tol):
        if not err <= tol:
            fail(f"{name} [{label}]: {err} against the plain version "
                 f"(gate {tol})")
        return err

    A, ms = timer(lambda: thmm.log_block_transfer(*chain, bs, nb))
    A_p, pms = timer(lambda: thmm._log_block_transfer_plain(*chain, bs, nb),
                     reps=1, warm=0)
    err = same_log_bits(torch, f"log_block_transfer [{label}]", A, A_p)
    rec.record("log_block_transfer", err, ms, pms, e_bytes + nb * C * 32,
               S * C * FLOPS_LOG["log_block_transfer"], peak=PEAK_F64)

    out, ms = timer(lambda: thmm.log_combine(A, F_t))
    out_p, pms = timer(lambda: thmm._log_combine_plain(A, F_t), reps=1,
                       warm=0)
    err = same_log_bits(torch, f"log_combine [{label}]", out, out_p)
    rec.record("log_combine", err, ms, pms, nb * C * (32 + 32) + C * 24,
               nb * C * FLOPS_LOG["log_combine"], peak=PEAK_F64)
    for L in chunks:
        same_log_bits(torch, f"log_combine [{label}] L={L}",
                      thmm._log_combine(A, F_t, L),
                      thmm._log_combine_plain(A, F_t, L))
    fw_in, bw_out, ll_f, ll_b = out
    rec.finite("log_combine", ll_f, ll_b)
    sweep = chain + (fw_in, bw_out, ll_f, bs)

    p, ms_p = timer(lambda: thmm.log_sweep(*sweep))
    p_p, pms_p = timer(lambda: thmm._log_sweep_plain(*sweep, False), reps=1,
                       warm=0)
    err_p = gate("log_sweep (posterior)", float((p - p_p).abs().max()),
                 LOG_P_ATOL)
    g, ms = timer(lambda: thmm.log_sweep(*sweep, grad=True))
    g_p, pms = timer(lambda: thmm._log_sweep_plain(*sweep, True), reps=1,
                     warm=0)
    err_g = gate("log_sweep (grad)", log_err(torch, g, g_p), LOG_G_RTOL)
    rec.finite("log_sweep", p, g)
    # the instances that compute the transitions again in the backward
    # pass (log_sweep parks them only while its scratch fits in
    # LOG_PARK_SHARE of the free memory): the parking instances' bits
    if dev.type == "cuda":
        parks = [thmm.log_sweep_parks(S, C, grad, cuda_lib.free_bytes(dev))
                 for grad in (False, True)]
        again = []
        for grad, want in ((False, p), (True, g)):
            got, t = timer(lambda: thmm.log_sweep(*sweep, grad=grad,
                                                  park=False))
            again.append(f"{t:.3f} ms, bit-equal {torch.equal(got, want)}")
            if not torch.equal(got, want):
                fail(f"log_sweep [{label}]: the instance that computes the "
                     f"transitions again differs (grad={grad})")
        log(f"[{label}] log_sweep parks the transitions here (posterior, "
            f"grad): {parks}; computing them again: posterior {again[0]}, "
            f"grad {again[1]}")
    in_bytes = e_bytes + nb * C * 32 + C * 8
    # the grad mode (every L-BFGS evaluation) is the kernel's line; the
    # posterior mode (the E-step) rides beside it
    rec.record("log_sweep", max(err_p, err_g), ms, pms,
               in_bytes + nb * C * 16, S * C * FLOPS_LOG["log_sweep_grad"],
               peak=PEAK_F64)
    b_ms = max((in_bytes + S * C * 8) / PEAK_BYTES,
               S * C * FLOPS_LOG["log_sweep"] / PEAK_F64) * 1e3
    results["log_sweep"]["posterior_mode"] = dict(
        ms=ms_p, plain_ms=pms_p, bound_ms=b_ms, max_abs_err=err_p)
    log(f"[{label}] log_sweep posterior mode: max diff {err_p:.3g}, kernel "
        f"{ms_p:.3f} ms, plain {pms_p:.1f} ms, bound {b_ms:.4f} ms")
    del A, A_p, out_p, p_p, g_p

    # ---- maf_log on the chain's snapped posterior (of the last replicate
    # where the columns hold R of them: a strided view, read in place)
    ps_all = check_interv(p)
    ps = ps_all[:, C - N:]
    f_k, _ = check_maf_log(torch, label, gl_t, ps, rec, timer)
    # the same columns strided (replicate 1 of R = 2), or contiguous
    other = (tmaf.est_maf(gl_t, torch.cat([ps * 0.5, ps], dim=1)[:, N:])
             if C == N else tmaf.est_maf(gl_t, ps.contiguous()))
    if not torch.equal(other, f_k):
        fail(f"maf_log [{label}]: strided replicate columns differ")
    del p, g, ps, ps_all, other

    if not oracle:
        return
    # ---- the public chain functions against the per-site oracle loops
    p_k, lf_k, lb_k = thmm.posteriors(*chain)
    p_s, lf_s, lb_s = thmm.posteriors_sites(*chain)
    L_k, gF_k, ga_k = thmm.loglik_value_and_grad(F_t, a_t, e, dist_t)
    L_s, gF_s, ga_s = thmm.loglik_value_and_grad_sites(F_t, a_t, e, dist_t)
    rel_ll = max(float(((a - b).abs() / b.abs()).max())
                 for a, b in ((lf_k, lf_s), (lb_k, lb_s), (L_k, L_s)))
    d_p = float((p_k - p_s).abs().max())
    rel_g = max(float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
                for a, b in ((gF_k, gF_s), (ga_k, ga_s)))
    log(f"[{label}] the kernels against the per-site oracle: ll rel "
        f"{rel_ll:.3g}, p_ibd {d_p:.3g}, gradient rel {rel_g:.3g}")
    if rel_ll > ORACLE_LL_RTOL or d_p > ORACLE_P_ATOL or rel_g > \
            ORACLE_G_RTOL:
        fail(f"[{label}] the scan tier's kernels off the per-site oracle")
    # ---- float64 Viterbi (the scan path's decode) against its plain loop
    for compat in (True, False):
        pk, sk = thmm.viterbi(*chain, compat=compat)
        pp, sp = thmm._viterbi_plain(*chain, compat, None, None)
        mism = int((pk != pp).sum())
        if mism or not torch.equal(sk, sp):
            fail(f"viterbi float64 [{label}] compat={compat}: {mism} path "
                 f"cells differ, scores equal {torch.equal(sk, sp)}")
    log(f"[{label}] viterbi float64: paths equal to the plain version, "
        "scores bit-equal (both variants)")


def log_gap64(torch, got, want):
    """A float32 output against the float64 kernel's on the same inputs:
    the largest |got - want| / max(|want|, 1) over the entries finite in
    both, and how many entries are finite in only one (a float32 decay or
    product may flush where the float64 one does not)."""
    got = got.to(want.dtype)
    fin = torch.isfinite(got) & torch.isfinite(want)
    n_odd = int((torch.isfinite(got) != torch.isfinite(want)).sum())
    if not bool(fin.any()):
        return 0.0, n_odd
    rel = (got - want).abs() / want.abs().clamp_min(1.0)
    return float(rel[fin].max()), n_odd


def check_log32_kernels(torch, dev, gl, dist, freq, F, alpha, label,
                        results, e_prob=None):
    """The float32 instances of the scan tier's chain kernels
    (csrc/log_chain.cu: log_block_transfer_f32, log_combine_f32,
    log_sweep_f32 in both modes, parking and recomputing) against their
    plain versions on `dev` at this shape: the float32 emissions of (gl,
    freq) (or e_prob [S, C, 2], R = C / N flattened replicates, rounded to
    float32), every output bit for bit, or the run fails. Each is timed
    beside its plain version and its bound (bytes, or float32 operations
    over PEAK_F32 with expf and logf read from their SASS; log_combine's
    float64 walks over PEAK_F64), and its outputs are printed against the
    float64 kernels' on the same inputs (widened)."""
    from ngsf_hmm_tpu_torch.models import hmm as thmm
    from ngsf_hmm_tpu_torch.ops.emissions import calc_emission

    timer = Timer(torch, dev)
    f32, f64 = torch.float32, torch.float64
    S = gl.shape[0]
    dist_t = torch.as_tensor(dist).to(dev, f32)
    F_t = torch.as_tensor(F).to(dev, f32)
    a_t = torch.as_tensor(alpha).to(dev, f32)
    if e_prob is None:
        e = calc_emission(torch.as_tensor(gl).to(dev).to(f32),
                          torch.as_tensor(freq).to(dev, f32)[:, None])
    else:
        e = e_prob.to(f32)
    C = e.shape[1]
    bs, nb = thmm.log_geometry(S, C, f32)
    log(f"[{label}] scan tier float32: S={S} columns={C} bs={bs} nb={nb} "
        f"lanes={nb * C}")
    rec = Recorder(torch, label, results)
    chain = (e, dist_t, F_t, a_t)
    chain64 = tuple(t.to(f64) for t in chain)
    e_bytes = S * C * 8 + S * 4 + C * 8

    A, ms = timer(lambda: thmm.log_block_transfer(*chain, bs, nb))
    A_p, pms = timer(lambda: thmm._log_block_transfer_plain(*chain, bs, nb),
                     reps=1, warm=0)
    err = same_log_bits(torch, f"log_block_transfer_f32 [{label}]", A, A_p)
    rec.record("log_block_transfer_f32", err, ms, pms, e_bytes + nb * C * 16,
               S * C * FLOPS_LOG32["log_block_transfer"])
    del A_p
    A64 = thmm.log_block_transfer(*chain64, bs, nb)
    log(f"[{label}] log_block_transfer_f32 against the float64 kernel on "
        f"the same inputs: %.3g (relative to max(|A|, 1)), %d entries "
        f"finite in one only" % log_gap64(torch, A, A64))

    out, ms = timer(lambda: thmm.log_combine(A, F_t))
    out_p, pms = timer(lambda: thmm._log_combine_plain(A, F_t), reps=1,
                       warm=0)
    err = same_log_bits(torch, f"log_combine_f32 [{label}]", out, out_p)
    rec.record("log_combine_f32", err, ms, pms,
               nb * C * (16 + 32) + C * (4 + 16),
               nb * C * FLOPS_LOG["log_combine"], peak=PEAK_F64)
    del out_p
    rec.finite("log_combine_f32", out[2], out[3])
    out64 = thmm.log_combine(A64, F_t.to(f64))
    d_ll = max(float(((a - b).abs() / b.abs()).max())
               for a, b in zip(out[2:], out64[2:]))
    log(f"[{label}] log_combine_f32 against the float64 kernel: ll_f, ll_b "
        f"relative {d_ll:.3g}; |ll_f - ll_b| "
        f"{float((out[2] - out[3]).abs().max()):.3g} (float64 walks)")

    sweep = chain + tuple(out[:3]) + (bs,)
    sweep64 = chain64 + tuple(out64[:3]) + (bs,)
    # the instance log_sweep runs for float32 (recomputing the
    # transitions) is the kernel's line; the parking one beside it
    mine = {}
    for grad in (False, True):
        want, pms = timer(lambda: thmm._log_sweep_plain(*sweep, grad),
                          reps=1, warm=0)
        for park in (True, False):
            got, t = timer(lambda: thmm.log_sweep(*sweep, grad=grad,
                                                  park=park))
            mode = "grad" if grad else "posterior"
            err = same_log_bits(
                torch, f"log_sweep_f32 {mode} park={park} [{label}]", got,
                want)
            mine[grad, park] = (got, t, pms, err)
    p, ms_p, pms_p, err_p = mine[False, False]
    g, ms, pms, err_g = mine[True, False]
    rec.finite("log_sweep_f32", p, g)
    in_bytes = e_bytes + nb * C * 32 + C * 8
    rec.record("log_sweep_f32", max(err_p, err_g), ms, pms,
               in_bytes + nb * C * 8, S * C * FLOPS_LOG32["log_sweep_grad"])
    b_ms = max((in_bytes + S * C * 4) / PEAK_BYTES,
               S * C * FLOPS_LOG32["log_sweep"] / PEAK_F32) * 1e3
    results["log_sweep_f32"]["posterior_mode"] = dict(
        ms=ms_p, plain_ms=pms_p, bound_ms=b_ms, max_abs_err=err_p)
    p64 = thmm.log_sweep(*sweep64)
    g64 = thmm.log_sweep(*sweep64, grad=True)
    d_p = float((p.to(f64) - p64).abs().max())
    d_g = float(((g.to(f64).sum(0) - g64.sum(0)).abs()
                 / g64.sum(0).abs().clamp_min(1.0)).max())
    log(f"[{label}] log_sweep_f32: posterior kernel {ms_p:.3f} ms (plain "
        f"{pms_p:.1f}, bound {b_ms:.4f}); the parking instances: posterior "
        f"{mine[False, True][1]:.3f} ms, grad {mine[True, True][1]:.3f} ms; "
        f"against the float64 kernel on the same inputs: p_ibd {d_p:.3g}, "
        f"gradient sums relative {d_g:.3g}")
    del mine, p, g, p64, g64, A, A64, out, out64


def extreme_chain32(torch, dev, S, N, seed):
    """extreme_chain's cases scaled to float32's range: F = 0, 1 and 1e-40
    (a subnormal float32) in columns 0-2, a decay of exp(-90) (subnormal in
    float32) at one site of columns 0 and 1 (column 0's T11 = x), columns
    4-9 whose two states' emissions stay 25 nats apart (rows drifting
    thousands of nats apart), runs of -inf emissions of one state and one
    site of both, emission gaps of 100 and 300 nats (past expf's range)
    in columns 13-25 and of 3e6 nats (past the 2^20-nat clamp) in columns
    26 on, chromosome breaks and runs of sites at distance 0."""
    rng = np.random.default_rng(seed)
    e = np.log(rng.uniform(1e-5, 1.0, (S, N, 2)))
    dist = rng.uniform(0.001, 0.3, S)
    dist[0] = 1.5
    dist[S // 3::S // 3] = np.inf
    dist[100:140] = 0.0
    F = rng.uniform(0.05, 0.9, N)
    alpha = rng.uniform(0.01, 0.5, N)
    F[:3] = (0.0, 1.0, 1e-40)
    alpha[:2] = 300.0
    dist[S // 2] = 0.3  # columns 0, 1: x = exp(-90)
    for c in range(4, 10):
        k = c % 2
        e[:, c, 1 - k] = e[:, c, k] - 25.0
    F[4:10:2], F[5:10:2] = 0.0, 1.0
    e[1000:1050, 10, 1] = -np.inf
    e[2000:2010, 11, 0] = -np.inf
    e[S // 4, 12, :] = -np.inf
    for c in range(13, N):
        sites = rng.integers(0, S, 50)
        k = c % 2
        gap = 3e6 if c >= 26 else (100.0 if c % 3 else 300.0)
        e[sites, c, k] = e[sites, c, 1 - k] - gap
    t = lambda x: torch.as_tensor(x).to(dev, torch.float32)
    return t(e), t(dist), t(F), t(alpha)


def check_log32_extremes(torch, dev, seed, S=20_011, N=40):
    """The float32 chain kernels bit-equal to their plain versions on
    extreme_chain32's inputs, at log_geometry's blocks and at blocks of
    1,200 sites: log_block_transfer_f32, log_combine_f32 (also at chunk
    length nb), log_sweep_f32 in both modes, parking and recomputing.
    Prints the -inf entries, the widest gap between a row's finite
    entries, the sites whose emission gap takes the split form, and the
    float32 products against the float64 kernel's on the same inputs."""
    from ngsf_hmm_tpu_torch.models import hmm as thmm

    chain = extreme_chain32(torch, dev, S, N, seed)
    e, F_t = chain[0], chain[2]
    g = (e[..., 0] - e[..., 1]).abs()
    log(f"[extreme float32] S={S} columns={N}: {int((g > 87).sum())} "
        f"(site, column) gaps past -87 nats, {int((g > 2 ** 20).sum())} "
        f"past -2^20")
    for bs, nb in (thmm.log_geometry(S, N, torch.float32),
                   (1_200, -(-S // 1_200))):
        what = f"extreme float32 S={S} columns={N} bs={bs} nb={nb}"
        A = thmm.log_block_transfer(*chain, bs, nb)
        same_log_bits(torch, f"log_block_transfer_f32 [{what}]", A,
                      thmm._log_block_transfer_plain(*chain, bs, nb))
        for L in (thmm.log_combine_chunk_len(nb), nb):
            same_log_bits(torch, f"log_combine_f32 [{what}] L={L}",
                          thmm._log_combine(A, F_t, L),
                          thmm._log_combine_plain(A, F_t, L))
        fw_in, bw_out, ll_f, _ = thmm.log_combine(A, F_t)
        sweep = chain + (fw_in, bw_out, ll_f, bs)
        for grad in (False, True):
            want = thmm._log_sweep_plain(*sweep, grad)
            for park in (True, False):
                same_log_bits(
                    torch, f"log_sweep_f32 grad={grad} park={park} [{what}]",
                    thmm.log_sweep(*sweep, grad=grad, park=park), want)
        A64 = thmm.log_block_transfer(*(t.double() for t in chain), bs, nb)
        fin = torch.isfinite(A[..., 0]) & torch.isfinite(A[..., 1])
        gap = (A[..., 0] - A[..., 1]).abs()[fin]
        keep = torch.arange(N, device=A.device) < 26  # past the clamp: apart
        log(f"[{what}] -inf entries of A {int(torch.isneginf(A).sum())} of "
            f"{A.numel()} (float64 kernel {int(torch.isneginf(A64).sum())}), "
            f"widest gap between a row's finite entries "
            f"{float(gap.max()):.1f} nats; against the float64 kernel "
            f"(columns below the clamp) %.3g, %d entries finite in one only"
            % log_gap64(torch, A[:, keep], A64[:, keep]))


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


def log_fit(torch, label, peak, S, C):
    """A scan-tier path's peak memory a site and column, and the sites of
    C columns that the card's memory would hold if the peak grew linearly
    with the sites (an extrapolation from this run, not a run)."""
    total = torch.cuda.get_device_properties(0).total_memory
    per = peak * 2**30 / (S * C)
    log(f"[{label}] peak {per:.1f} B a site and column: about "
        f"{int(total / per / C):,} sites of {C} columns in the card's "
        f"{total / 2**30:.1f} GiB (linear extrapolation)")


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
             need, writers, gl_bf16=False, against=None, dtype=None):
    """init_state -> run_em [-> writers] with the launch counts set to 0
    just before and read just after; fails unless every kernel in `need`
    was launched, no plain version was called and what came out is sound.
    gl_bf16: the run's gl slabs in bfloat16 (EMOptions.gl_bf16); no
    float32 gl-slab kernel may launch then. Under freq_est 1 with a macro
    schedule (N >= 32) the path ends with slab_est_maf_step. against: the
    (freq, ind_lkl) of a float32 run of the same data, held at the bf16
    envelopes. dtype: the state's float type (float32 by default; the
    kernels read float32 either way, as the JAX package's do). Returns
    (the launch counts, (freq, ind_lkl) of the final state)."""
    from ngsf_hmm_tpu_torch.io.writers import write_geno, write_ibd, write_indF
    from ngsf_hmm_tpu_torch.models.em import (EMOptions, init_state,
                                              rebuild_eprob, run_em)
    from ngsf_hmm_tpu_torch.ops.maf import macro_schedule
    from ngsf_hmm_tpu_torch.utils import cuda_lib
    from ngsf_hmm_tpu_torch.utils.constants import (ALPHA_MAX, ALPHA_MIN,
                                                    F_MAX, F_MIN)

    S, N = gl.shape[0], gl.shape[1]
    opts = EMOptions(numerics="pallas", freq_est=freq_est, min_iters=3,
                     max_iters=4, verbose=0, gl_bf16=gl_bf16)
    # fixed frequencies are the simulated ones; estimated ones start flat
    freq0 = freq_true if freq_est == 0 else np.full(S, 0.2)
    iters = []

    def trace(event, **kw):
        if event == "iter_done":
            if dev.type == "cuda":
                torch.cuda.synchronize()
            iters.append((kw["dt"], kw["tot_lkl"], cuda_lib.LAUNCHES[
                "block_transfer_grad" + ("_bf16" if gl_bf16 else "")]))

    dtype = dtype or torch.float32
    reset_peak(torch, dev, label)
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    state = init_state(gl, freq0, indF0, alpha0, device=dev, dtype=dtype)
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
    if st.indF.dtype != dtype or st.e_prob.dtype != dtype:
        fail(f"[{label}] the state is not {dtype}")
    f32 = np.float32 if dtype == torch.float32 else np.float64
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
        want = rebuild_eprob(torch.as_tensor(gl[:1000]).to(dev, dtype),
                             st.freq[:1000])
        if torch.equal(e_head, e_prob0) or not torch.equal(e_head, want):
            fail(f"[{label}] e_prob was not rebuilt from the final freq")
        maf_ms = maf_timer.ms()
        if len(maf_ms) != res.n_iters:
            fail(f"[{label}] {len(maf_ms)} freq M-steps in {res.n_iters} "
                 "iterations")
    finals = (freq, to_np(st.ind_lkl))
    FINAL_FREQ[label] = freq
    FINAL_F[label] = indF
    if against is not None:
        d_freq = float(np.abs(freq - against[0]).max())
        d_ll = float((np.abs(finals[1] - against[1])
                      / np.abs(against[1])).max())
        log(f"[{label}] against the float32 run (main): freq max diff "
            f"{d_freq:.3g} (envelope {BF16_FREQ_ATOL}), ind_lkl max rel diff "
            f"{d_ll:.3g} (envelope {BF16_LL_RTOL})")
        if d_freq > BF16_FREQ_ATOL or d_ll > BF16_LL_RTOL:
            fail(f"[{label}] outside the bf16 envelopes: freq {d_freq}, "
                 f"ind_lkl {d_ll}")
    if writers:
        if sizes["geno"] != S * N * 3 * 8:
            fail(f".geno holds {sizes['geno']} bytes, expected {S * N * 24}")
        if sizes["ibd"] < N * (S + 1) + N * S * 9 or sizes["indF"] < S * 9:
            fail(f"output files too small: {sizes}")
    probes = np.diff([0] + [c for _, _, c in iters])
    log(f"[{label}] S={S} N={N} {str(dtype)[6:]} state, gl slabs "
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
    if dtype == torch.float64 and "main" in SUMMARY:
        m, me = SUMMARY["main"], SUMMARY[label]
        d_f = np.abs(indF - FINAL_F["main"])
        log(f"[{label}] beside main (float32 state, the same kernels' "
            f"inputs): streams {me['streams']} against {m['streams']}, "
            f"tot_lkl {me['tot_lkl']:.3f} against {m['tot_lkl']:.3f}, IBD "
            f"share {me['ibd']} against {m['ibd']}; F largest gap "
            f"{d_f.max():.4g}, mean {d_f.mean():.4g}")
    if dev.type == "cuda":
        log(f"[{label}] peak torch.cuda.max_memory_allocated "
            f"{max(peak_init, peak):.2f} GiB: init_state {peak_init:.2f} GiB, "
            f"run_em {peak:.2f} GiB")
    log(f"[{label}] launches {counts}; output bytes {sizes}")
    return counts, finals


def run_scan_path(torch, dev, gl, dist, freq_true, indF0, alpha0,
                  dtype=None):
    """The scan tier (the JAX package's default: --dtype float64 --kernel
    scan): init_state -> run_em (numerics "log", freq_est 1, min_iters 3,
    max_iters 4) -> Viterbi on the main path's data in float64 ("scan"),
    or with dtype float32 in float32 ("scan32", --dtype float32: the
    float32 chain kernels, maf_log's float32 instance, float32 Viterbi), no
    writers, with the launch counts set to 0 just before and read just
    after; fails unless the tier's kernels of that type and Viterbi were
    launched, no plain version was called and what came out is sound.
    Prints s an iteration, L-BFGS evaluations an iteration, ms of the freq
    M-step, s of Viterbi and the peak memory (init_state and run_em
    apart), and the largest gap between its final F and the main path's
    float32 F (scan32: and scan's F, tot_lkl and IBD share) (no gate).
    Returns the launch counts."""
    from ngsf_hmm_tpu_torch.models import em as tem
    from ngsf_hmm_tpu_torch.ops.emissions import calc_emission
    from ngsf_hmm_tpu_torch.utils import cuda_lib
    from ngsf_hmm_tpu_torch.utils.constants import (ALPHA_MAX, ALPHA_MIN,
                                                    F_MAX, F_MIN)

    ftype = dtype or torch.float64
    f32_tier = ftype == torch.float32
    label, sfx = ("scan32", "_f32") if f32_tier else ("scan", "")
    S, N = gl.shape[0], gl.shape[1]
    opts = tem.EMOptions(freq_est=1, min_iters=3, max_iters=4, verbose=0)
    iters = []

    def trace(event, **kw):
        if event == "iter_done":
            if dev.type == "cuda":
                torch.cuda.synchronize()
            iters.append((kw["dt"], kw["tot_lkl"],
                          cuda_lib.LAUNCHES["log_sweep" + sfx]))

    reset_peak(torch, dev, label)
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    gl_t = torch.as_tensor(gl).to(dev).to(ftype)
    dist_t = torch.as_tensor(dist).to(dev, ftype)
    state = tem.init_state(gl_t, np.full(S, 0.2), indF0, alpha0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    peak_init = peak_gib(torch, dev, reset=True)
    with MafTimer(torch, dev, tem, ("est_maf",)) as maf_timer, MafTimer(
            torch, dev, tem, ("viterbi",)) as vit_timer:
        res = tem.run_em(gl_t, dist_t, state, opts, trace=trace, device=dev)
    del state
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    peak = peak_gib(torch, dev)
    counts = dict(cuda_lib.LAUNCHES)
    plain = dict(cuda_lib.PLAIN_CALLS)

    # ---- what came out
    need = (LOG32_KERNELS + ("maf_log", "viterbi") if f32_tier
            else LOG_KERNELS + ("viterbi",))
    if dev.type == "cuda":
        if plain:
            fail(f"[{label}] the path called plain versions: {plain}")
        missing = [k for k in need if counts.get(k, 0) < 1]
        if missing:
            fail(f"[{label}] never launched: {missing} (counts {counts})")
        other = [k for k in counts if k not in need]
        if other:
            fail(f"[{label}] the scan tier launched {other}")
    elif not plain:
        fail("rehearsal: no plain version was called")
    if not (opts.min_iters <= res.n_iters <= opts.max_iters
            and len(iters) == res.n_iters):
        fail(f"[{label}] expected 3 or 4 EM iterations, ran {res.n_iters}")
    h = res.lkl_history
    # freq estimated: run_path's gate (the run ends above its start, no
    # step loses more than 1e-4 of |ll|)
    if not np.all(np.isfinite(h)) or not h[-1] > h[0] or any(
            b < a - 1e-4 * abs(h[0]) for a, b in zip(h, h[1:])):
        fail(f"[{label}] total log-likelihood went wrong: {h}")
    st = res.state
    to_np = lambda t: t.detach().cpu().numpy()
    indF, alpha, freq = to_np(st.indF), to_np(st.alpha), to_np(st.freq)
    p_ibd = to_np(st.p_ibd)
    if st.freq.dtype != ftype or st.e_prob.dtype != ftype:
        fail(f"[{label}] the state is not {ftype}")
    if not (np.all(indF >= F_MIN) and np.all(indF <= F_MAX)
            and np.all(alpha >= ALPHA_MIN) and np.all(alpha <= ALPHA_MAX)):
        fail(f"[{label}] indF / alpha outside their boxes")
    if p_ibd.shape != (S, N) or not np.all((p_ibd >= 0) & (p_ibd <= 1)):
        fail(f"[{label}] p_ibd not in [0, 1] or of the wrong shape")
    if res.path.shape != (S, N) or not np.isin(res.path, (0, 1)).all():
        fail(f"[{label}] Viterbi path not in {{0, 1}} or of the wrong shape")
    if freq.shape != (S,) or not np.all(np.isfinite(freq)) or not np.all(
            (freq >= 0) & (freq <= 1)):
        fail(f"[{label}] freq not finite in [0, 1] or of the wrong shape")
    want = calc_emission(gl_t[:1000], st.freq[:1000, None])
    if not torch.equal(st.e_prob[:1000], want):
        fail(f"[{label}] e_prob is not calc_emission of the final freq")
    f_err = float(np.abs(freq - freq_true).mean())
    corr = float(np.corrcoef(freq, freq_true)[0, 1])
    log(f"[{label}] freq: mean |freq - simulated| {f_err:.4f}, correlation "
        f"with the simulated {corr:.3f}")
    if f_err > 0.2 or corr < 0.3:
        fail(f"[{label}] estimated freq unrelated to the simulated one")
    maf_ms, vit_ms = maf_timer.ms(), vit_timer.ms()
    if len(maf_ms) != res.n_iters or len(vit_ms) != 1:
        fail(f"[{label}] {len(maf_ms)} freq M-steps in {res.n_iters} "
             f"iterations, {len(vit_ms)} Viterbi calls")
    FINAL_FREQ[label] = freq
    FINAL_F[label] = indF

    sweeps = np.diff([0] + [c for _, _, c in iters])
    log(f"[{label}] S={S} N={N} {str(ftype)[6:]} scan tier (numerics 'log'), "
        f"freq_est 1: init_state {t_init:.2f} s, init + {res.n_iters} EM "
        f"iterations + Viterbi {t_all:.2f} s")
    for i, ((dt, tot, _), n_sw) in enumerate(zip(iters, sweeps), 1):
        log(f"[{label}] iteration {i}: {dt:.3f} s, tot_lkl {tot:.3f}, chain "
            f"sweeps {n_sw} (E-step 1 + L-BFGS evaluations {n_sw - 1}), "
            f"L-BFGS outer iterations {res.opt_iters[i - 1]}, freq M-step "
            f"(maf_log) {maf_ms[i - 1]:.3f} ms")
    log(f"[{label}] Viterbi ({str(ftype)[6:]}) {vit_ms[0] / 1e3:.3f} s; mean "
        f"indF "
        f"{indF.mean():.4f}, mean alpha {alpha.mean():.4f}, Viterbi IBD "
        f"share {res.path.mean():.4f}, mean p_ibd {p_ibd.mean():.4f}")
    if "main" in FINAL_F:
        d = np.abs(indF - FINAL_F["main"])
        log(f"[{label}] final F against the main path's float32 F (same "
            f"data, fused tier): largest gap {d.max():.4g} (individual "
            f"{int(d.argmax()) + 1}), mean gap {d.mean():.4g} (no gate)")
    SUMMARY[label] = dict(sweeps=[int(n) for n in sweeps],
                          tot_lkl=float(iters[-1][1]),
                          ibd=f"{res.path.mean():.4f}")
    if f32_tier and "scan" in SUMMARY:
        d = np.abs(indF - FINAL_F["scan"])
        m = SUMMARY["scan"]
        log(f"[{label}] beside scan (float64, same data): final F largest "
            f"gap {d.max():.4g} (individual {int(d.argmax()) + 1}), mean gap "
            f"{d.mean():.4g}; sweeps {SUMMARY[label]['sweeps']} against "
            f"{m['sweeps']}; tot_lkl {SUMMARY[label]['tot_lkl']:.3f} against "
            f"{m['tot_lkl']:.3f}; IBD share {SUMMARY[label]['ibd']} against "
            f"{m['ibd']}; freq largest gap "
            f"{float(np.abs(freq - FINAL_FREQ['scan']).max()):.4g} (no gate)")
    if dev.type == "cuda":
        log(f"[{label}] peak torch.cuda.max_memory_allocated "
            f"{max(peak_init, peak):.2f} GiB: init_state {peak_init:.2f} GiB, "
            f"run_em {peak:.2f} GiB")
        log_fit(torch, label, max(peak_init, peak), S, N)
    log(f"[{label}] launches {counts}")
    return counts


# per path: L-BFGS streams per iteration, final tot_lkl, Viterbi IBD share
SUMMARY = {}
# per path: the final freq [S]
FINAL_FREQ = {}
# per path: the final indF [N]
FINAL_F = {}


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


# the paths whose final freqs --maf-anchor writes and --against-maf holds
# (freq_e: the fused tier's --freq e initial estimate at the main shape)
ANCHOR_PATHS = ("main", "bf16", "exact", "ld", "ld2", "restart", "freq_e",
                "scan", "scan_restart")
# the fused tier's CLI runs (--freq e) whose outputs it keeps and holds
ANCHOR_CLI = ("cli", "cli_ld")


def run_maf_anchor(torch, dev, args):
    """--maf-anchor OUT: the float64 anchor of the est_maf functions
    (est_maf_exact at the exact path's shape, macro_slab and est_maf_slab
    at the main path's, est_maf_slab on bfloat16 slabs, est_maf_rows on
    the LD path's rows), then the main (without the writers), bf16, exact,
    ld, ld2, restart, scan and scan_restart paths, the fused tier's
    --freq e estimate at the main shape and its CLI runs with --freq e
    (one run, and the LD path),
    on this tree's package or on --tree's; writes the anchor's readings
    (anchor.json), the paths' final freqs ({label}_freq.npy) and the CLI
    runs' outputs ({tag}.indF, {tag}.ibd) under OUT for --against-maf,
    and with --against-maf holds them to that tree's. Prints no result
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
    _, main = run_path(torch, dev, "main", gl, dist, freq, F0, a0, 1,
                       CHAIN_KERNELS + SLAB_KERNELS, writers=False)
    run_path(torch, dev, "bf16", gl, dist, freq, F0, a0, 1,
             BF16_KERNELS + ("combine_blocks", "viterbi", "maf_window"),
             writers=False, gl_bf16=True, against=main)
    run_path(torch, dev, "exact", gl_x, dist_x, freq_x, F0_x, a0_x, 1,
             CHAIN_KERNELS + ("maf_exact",), writers=False)
    run_ld_path(torch, dev, "ld", gl, dist, freq, F0, a0, 1)
    S_c = args.check_sites  # ld2 as main() runs it
    run_ld_path(torch, dev, "ld2", np.ascontiguousarray(gl[:S_c]),
                dist[:S_c], freq[:S_c], F0, a0, 2)
    from ngsf_hmm_tpu_torch.io.gsl_rng import GslTaus
    from ngsf_hmm_tpu_torch.io.init import init_freq

    FINAL_FREQ["freq_e"] = init_freq("e", gl.shape[0], GslTaus(args.seed),
                                     gl=gl, device=dev)
    log(f"[freq_e] the --freq e estimate at S={gl.shape[0]} N={gl.shape[1]} "
        f"{gl.dtype}: mean {FINAL_FREQ['freq_e'].mean():.6f}")
    run_scan_path(torch, dev, gl, dist, freq, F0, a0)
    del gl
    gl_c, dist_c, freq_c, _, _ = simulate(args.check_sites, args.ind,
                                          args.seed + 7, n_chrom=1)
    step = max(2, min(100_000, args.check_sites // 2))
    dist_c[step::step] = np.inf  # as main() makes the restart path's data
    for scan in (False, True):
        run_restart_path(torch, dev, gl_c, dist_c, freq_c, 3 if dev.type ==
                         "cpu" else 20, args.seed + 5, scan=scan)
    tree = os.path.abspath(args.tree) if args.tree else None
    run_cli(dev, args.seed, keep=out / "cli", cwd=tree)
    run_cli(dev, args.seed, ld=True, keep=out / "cli_ld", cwd=tree)
    (out / "anchor.json").write_text(json.dumps(ANCHORS, indent=1))
    for label in ANCHOR_PATHS:
        np.save(out / f"{label}_freq.npy", FINAL_FREQ[label])
    log(f"maf anchor written to {out}; no result is printed for it")
    if args.against_maf:
        against_maf(args.against_maf, out)
    return 4


def _indf_parts(path):
    """A .indF file's numbers: the log-likelihood, the [N, 2] (F, alpha)
    rows (NA as NaN) and the freqs."""
    lines = [line.split() for line in open(path) if line.strip()]
    num = lambda t: np.nan if t == "NA" else float(t)
    return {"logLkl": np.array([num(lines[0][0])]),
            "F alpha": np.array([[num(t) for t in row] for row in lines[1:]
                                 if len(row) == 2]),
            "freq": np.array([num(row[0]) for row in lines[1:]
                              if len(row) == 1])}


def against_maf(path, mine_dir=None):
    """Sets this run's float64 anchor beside another tree's and holds the
    ANCHOR_PATHS' final freqs to that tree's (run_maf_anchor's files under
    `path`, the same data from the same seed; those of the paths it
    wrote): prints whether each function's largest and mean distance from
    float64 and its share of sites off by a step are no larger than there
    (information) and whether each path's final freqs are bit-equal to
    there's; fails unless they are within MAF_FREQ_ATOL of there. With
    mine_dir (this run's --maf-anchor files) also the CLI runs' outputs:
    .indF bit-equal or its largest difference (the log-likelihood, F,
    alpha, freqs), .ibd paths equal (information)."""
    import pathlib

    path = pathlib.Path(path)
    there = json.loads((path / "anchor.json").read_text())
    bad = []
    for key, r in there.items():
        mine = ANCHORS.get(key)
        if mine is None:
            fail(f"{key}: no float64 anchor in this run")
        closer = {k: mine[k] <= r[k] for k in ("max", "mean", "share")}
        log(f"{key} against {path}: from float64 max {mine['max']:.4g} "
            f"(there {r['max']:.4g}), mean {mine['mean']:.4g} (there "
            f"{r['mean']:.4g}), sites off {mine['share']:.4g} (there "
            f"{r['share']:.4g}); no further than there: {closer}")
    for label in ANCHOR_PATHS:
        if label not in FINAL_FREQ or not (path /
                                           f"{label}_freq.npy").exists():
            continue
        want = np.load(path / f"{label}_freq.npy")
        d = float(np.abs(FINAL_FREQ[label] - want).max())
        log(f"[{label}] final freq against {path}: max diff {d:.3g}, "
            f"sites differing {int((FINAL_FREQ[label] != want).sum())} of "
            f"{want.size}, bit-equal {np.array_equal(FINAL_FREQ[label], want)}")
        if d > MAF_FREQ_ATOL:
            bad.append(f"[{label}] final freq off {path}'s by {d}")
    for tag in ANCHOR_CLI if mine_dir is not None else ():
        files = [pathlib.Path(q) / f"{tag}.{ext}" for q in (mine_dir, path)
                 for ext in ("indF", "ibd")]
        if not all(f.exists() for f in files):
            continue
        a, b = (_indf_parts(f) for f in files[0::2])
        diffs = {k: (float(np.nanmax(np.abs(a[k] - b[k]), initial=0.0))
                     if a[k].shape == b[k].shape else np.inf) for k in a}
        same = files[0].read_bytes() == files[2].read_bytes()
        ibd_same = files[1].read_bytes() == files[3].read_bytes()
        log(f"[{tag}] CLI --freq e (fused tier) against {path}: .indF "
            f"bit-equal {same}, largest differences " + ", ".join(
                f"{k} {v:.3g}" for k, v in diffs.items())
            + f"; .ibd equal {ibd_same}")
    if bad:
        fail("; ".join(bad))


def run_restart_path(torch, dev, gl, dist, freq_true, R, seed, scan=False,
                     ld=False):
    """stack_restart_states -> run_em_restarts (R lockstep replicates
    flattened into the columns, freq_est 1, min_iters 3, max_iters 4,
    best-replicate Viterbi; no writers) with the launch counts set to 0
    just before and read just after; fails unless every kernel of the
    route was launched, no plain version was called and what came out is
    sound. scan: on the float64 scan tier ("scan_restart": the log chain
    over the R * N columns, maf_log a replicate) instead of the fused
    tier's emission-slab kernels ("restart"). ld (with scan,
    "scan_ld_restart"): --freq_est 2 --e_prob 2, each replicate's
    haplotype EM at init (its LD emissions from its own freq0) and every
    iteration on its own columns, maf_log on its site 0; the log-likelihood
    gate is the LD path's (finite, |ll_f - ll_b| <= 1e-3), not the
    monotone one. Returns the launch counts."""
    from ngsf_hmm_tpu_torch.models import em as tem
    from ngsf_hmm_tpu_torch.models.restart import (run_em_restarts,
                                                   stack_restart_states)
    from ngsf_hmm_tpu_torch.ops.emissions import calc_emission
    from ngsf_hmm_tpu_torch.utils import cuda_lib

    label = ("scan_ld_restart" if ld else "scan_restart") if scan \
        else "restart"
    S, N = gl.shape[0], gl.shape[1]
    modes = dict(freq_est=2, e_prob_calc=2) if ld else dict(freq_est=1)
    opts = tem.EMOptions(numerics="log" if scan else "pallas", min_iters=3,
                         max_iters=4, verbose=0, **modes)
    dtype = torch.float64 if scan else torch.float32
    stream = "log_sweep" if scan else "block_transfer_grad_v1"
    iters = []

    def trace(event, **kw):
        if event == "iter_done":
            if dev.type == "cuda":
                torch.cuda.synchronize()
            iters.append((kw["dt"], kw["tot_lkl"].copy(), kw["active"].copy(),
                          cuda_lib.LAUNCHES[stream]))

    from ngsf_hmm_tpu_torch.models import restart as trestart

    em_iteration, fwbw = trestart.em_iteration, []

    def tapped(*a, **kw):  # records each iteration's max |ll_f - ll_b|
        out = em_iteration(*a, **kw)
        fwbw.append(float(out[1].fwbw_maxdiff.max()))
        return out

    reset_peak(torch, dev, label)
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    gl = torch.as_tensor(gl).to(dev).to(dtype)
    # the ngsF-HMM.sh protocol: random inits, replicate r from seed + r
    box = [stack_restart_states(gl, R, seed, device=dev, **modes)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    peak_init = peak_gib(torch, dev, reset=True)
    timed = (tem, ("est_maf",)) if scan else (None, None)
    trestart.em_iteration = tapped
    try:
        with MafTimer(torch, dev, *timed) as maf_timer, MafTimer(
                torch, dev, tem, ("haplo_freq",)) as hap_timer:
            # handed over without a reference kept here: run_em_restarts
            # holds only its flattened copy
            res = run_em_restarts(gl, dist, box.pop(), opts, trace=trace,
                                  device=dev)
    finally:
        trestart.em_iteration = em_iteration
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    counts = dict(cuda_lib.LAUNCHES)
    plain = dict(cuda_lib.PLAIN_CALLS)

    # ---- what came out
    need = (LOG_KERNELS + ("viterbi",) if scan else
            V1_KERNELS + ("combine_blocks", "viterbi") + SLAB_KERNELS)
    if dev.type == "cuda":
        if plain:
            fail(f"[{label}] the path called plain versions: {plain}")
        missing = [k for k in need if counts.get(k, 0) < 1]
        if missing:
            fail(f"[{label}] never launched: {missing} (counts {counts})")
        other = [k for k in counts if k not in need and (
            scan or k in CHAIN_KERNELS[:4])]
        if other:
            fail(f"[{label}] the flattened route launched {other}")
    elif not plain:
        fail("rehearsal: no plain version was called")
    n_it = len(iters)
    if not (opts.min_iters <= n_it <= opts.max_iters):
        fail(f"[{label}] expected 3 or 4 lockstep iterations, ran {n_it}")
    hist = np.array([t for _, t, _, _ in iters])  # [iterations, R]
    if hist.shape != (n_it, R) or not np.all(np.isfinite(hist)):
        fail(f"[{label}] non-finite or misshapen replicate totals: {hist}")
    # freq estimated: each replicate ends above its start, and no step
    # loses more than 1e-4 of |ll| (run_path's gate, per replicate); the
    # haplotype EM's freqs: the LD path's gate
    slack = 1e-4 * np.abs(hist[0])
    if ld:
        if len(fwbw) != n_it or max(fwbw) > 1e-3:
            fail(f"[{label}] |ll_f - ll_b| {fwbw}")
    elif not np.all(hist[-1] > hist[0]) or np.any(
            np.diff(hist, axis=0) < -slack):
        fail(f"[{label}] a replicate's log-likelihood went wrong: {hist}")
    if res.best_rep != int(np.argmax(res.rep_lkl)) or not np.array_equal(
            res.rep_lkl, hist[-1]):
        fail(f"[{label}] best replicate {res.best_rep} is not the argmax "
             f"of {res.rep_lkl}")
    best, freq = res.best, res.rep_freq
    FINAL_FREQ[label] = freq
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
    # (LD: site 0's emission is calc_emission's, the others the LD pair
    # emissions of the haplotype EM)
    head = 1 if ld else 1000
    want = (calc_emission(gl[:head], st.freq[:head, None]) if scan else
            tem.rebuild_eprob(gl[:head], st.freq[:head]))
    if not torch.equal(st.e_prob[:head], want) or not bool(
            torch.isfinite(st.e_prob).all()):
        fail(f"[{label}] the best replicate's e_prob is not its freq's")
    f_err = np.abs(freq - freq_true[None]).mean(1)
    corr = [float(np.corrcoef(f, freq_true)[0, 1]) for f in freq]
    maf_ms, hap_ms = maf_timer.ms(), hap_timer.ms()
    if len(maf_ms) != R * n_it or len(hap_ms) != (R * n_it if ld else 0):
        fail(f"[{label}] {len(maf_ms)} est_maf and {len(hap_ms)} haplotype "
             f"EM calls in {n_it} iterations of {R} replicates")

    log(f"[{label}] S={S} N={N} R={R} ({R * N} columns) "
        f"{'float64 scan tier' if scan else 'float32'} "
        f"{'--freq_est 2 --e_prob 2' if ld else 'freq_est 1'}: "
        f"init {t_init:.2f} s, init + {n_it} iterations + Viterbi "
        f"{t_all:.2f} s")
    probes = np.diff([0] + [c for _, _, _, c in iters])
    for i, ((dt, tot, act, _), n_str) in enumerate(zip(iters, probes), 1):
        m = maf_ms[(i - 1) * R:i * R]
        log(f"[{label}] iteration {i}: {dt:.3f} s, best tot_lkl "
            f"{tot.max():.3f} (replicate {int(np.argmax(tot)) + 1}), active "
            f"{int(act.sum())}/{R}, "
            + (f"chain sweeps {n_str} (E-step 1 + L-BFGS evaluations "
               f"{n_str - 1})" if scan else
               f"transfer+tangent streams {n_str} (L-BFGS probes)")
            + f", L-BFGS outer iterations {best.opt_iters[i - 1]}, freq "
            f"M-step {sum(m):.3f} ms ({R} "
            f"{'maf_log' if scan else 'est_maf_slab'} calls, "
            f"{min(m):.3f}-{max(m):.3f} ms each)"
            + (f", haplotype EM {sum(hap_ms[(i - 1) * R:i * R]) / 1e3:.3f} "
               f"s, |ll_f - ll_b| {fwbw[i - 1]:.3g}" if ld else ""))
    for r in range(R):
        log(f"[{label}] replicate {r + 1}: logLkl {res.rep_lkl[r]:.3f} "
            f"({res.rep_iters[r]} iters), mean |freq - simulated| {f_err[r]:.4f}, correlation {corr[r]:.3f}"
            + ("  <== best" if r == res.best_rep else ""))
    log(f"[{label}] best replicate {res.best_rep + 1}: Viterbi IBD share "
        f"{best.path.mean():.4f}, mean p_ibd {p_ibd.mean():.4f}")
    if dev.type == "cuda":
        peak = peak_gib(torch, dev)
        log(f"[{label}] peak torch.cuda.max_memory_allocated "
            f"{max(peak_init, peak):.2f} GiB: the inits {peak_init:.2f} GiB, "
            f"run_em_restarts {peak:.2f} GiB")
        if scan:
            log_fit(torch, label, max(peak_init, peak), S, R * N)
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
    opts = tem.EMOptions(numerics="pallas", freq_est=freq_est,
                         e_prob_calc=2, min_iters=3, max_iters=4, verbose=0)
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


def run_cli(dev, seed, n_rep=1, ld=False, gl_bf16=False, tier="pallas32",
            keep=None, cwd=None):
    """python -m ngsf_hmm_tpu_torch once at a small size on files made
    with numpy, on the tier named: "pallas32" the fused tier (--dtype
    float32 --kernel pallas), "scan" the default tier (no --dtype /
    --kernel: the float64 scan tier), "scan32" --dtype float32 alone (the
    float32 scan tier), "pallas64" --kernel pallas alone (the fused tier
    with a float64 state) (n_rep > 1: that many lockstep restarts, the best
    replicate's files; ld: --freq_est 2 --e_prob 2 at 40 individuals, the
    JAX package's warning on stderr; gl_bf16: --gl_bf16 1 at 40
    individuals, the slab est_maf route); exit code and outputs checked.
    keep: a path prefix the .indF and .ibd outputs are copied to; cwd: the
    directory whose package runs (another tree's; this script's by
    default)."""
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
        cmd += {"scan": [], "scan32": ["--dtype", "float32"],
                "pallas64": ["--kernel", "pallas"],
                "pallas32": ["--dtype", "float32", "--kernel", "pallas"]}[tier]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                           cwd=cwd or os.path.dirname(
                               os.path.abspath(__file__)))
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
        if keep is not None:
            import shutil

            for ext in (".indF", ".ibd"):
                shutil.copyfile(out + ext, str(keep) + ext)
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
            + {"scan": " (default tier: float64 scan)",
               "scan32": " --dtype float32 (the float32 scan tier)",
               "pallas64": " --kernel pallas (float64 state)",
               "pallas32": " --dtype float32 --kernel pallas"}[tier]
            + (" --freq_est 2 --e_prob 2" if ld else "")
            + (" --gl_bf16 1" if gl_bf16 else "")
            + f": {final.strip()}")


def main():
    t_script = time.perf_counter()
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
    ap.add_argument("--before", metavar="DIR",
                    help="only the scan tier's kernels timed against "
                    "another tree's (its package under DIR) in turns at "
                    "the scan and scan_restart shapes; exits 4")
    ap.add_argument("--scan-times", metavar="OUT",
                    help="only the scan tier's kernels timed at the scan "
                    "and scan_restart shapes, written under OUT (one run "
                    "of --before); exits 4")
    ap.add_argument("--against-times", metavar="REF",
                    help="with --scan-times: hold the outputs to another "
                    "--scan-times run's under REF")
    ap.add_argument("--probes", action="store_true",
                    help="only the build, transfer and est_maf probes at "
                    "the main and restart shapes; exits 4")
    ap.add_argument("--maf-anchor", metavar="OUT",
                    help="only the float64 anchor of the one-launch "
                    "est_maf functions, the main, bf16, exact, ld, ld2 and "
                    "restart paths, the fused --freq e estimate and CLI "
                    "runs, their readings, final freqs and CLI outputs "
                    "written under OUT; exits 4")
    ap.add_argument("--tree", metavar="DIR",
                    help="with --maf-anchor or --scan-times: run another "
                    "tree's package "
                    "(its ngsf_hmm_tpu_torch under DIR)")
    ap.add_argument("--against-maf", metavar="DIR",
                    help="hold the float64 anchor and the paths' final "
                    "freqs (with --maf-anchor also the CLI outputs) to "
                    "another tree's --maf-anchor files under DIR")
    args = ap.parse_args()
    if args.tree:
        if not (args.maf_anchor or args.scan_times):
            ap.error("--tree needs --maf-anchor or --scan-times")
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

    if args.before:
        return compare_trees(args)
    if args.scan_times and dev.type != "cuda":
        return run_scan_times(torch, dev, args)
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
            probe_transcendentals()
            return 4
        if args.maf_anchor or args.scan_times:
            cuda_lib.load()
            log(f"[build] {cuda_lib.CSRC} -> {cuda_lib.build()}")
            if args.scan_times:
                return run_scan_times(torch, dev, args)
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
        probe_transcendentals()
        log(f"[probe build] done in {time.perf_counter() - t0:.1f} s")
        check_window_division(torch)
        check_logsum_identity(torch)
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

    # ---- the scan tier's kernels (float64): at the ragged check shape
    # with breaks, against the per-site oracle (and float64 Viterbi) at a
    # small one; at the scan path's shape below
    # (log_combine also with its whole walk in one chunk, and at the
    # oracle shape at chunk length 1), then on the extreme inputs
    t0 = time.perf_counter()
    from ngsf_hmm_tpu_torch.models.hmm import log_geometry
    check_log_kernels(torch, dev, gl_c, dist_c, freq_c, F0_c, a0_c,
                      "check", results, chunks=(log_geometry(S_c, N)[1],))
    check_log32_kernels(torch, dev, gl_c, dist_c, freq_c, F0_c, a0_c,
                        "check", results)
    S_o, N_o = (211, 5) if args.rehearse else (2_003, 33)
    gl_o, dist_o, freq_o, F0_o, a0_o = simulate(S_o, N_o, args.seed + 23)
    dist_o[S_o // 2] = 0.0  # a site at distance 0: the identity
    check_log_kernels(torch, dev, gl_o, dist_o, freq_o, F0_o, a0_o,
                      "oracle shape", {}, oracle=True,
                      chunks=(1, log_geometry(S_o, N_o)[1]))
    check_log_extremes(torch, dev, args.seed + 37,
                       *((2_411, 20) if args.rehearse else (20_011, 40)))
    check_log32_extremes(torch, dev, args.seed + 41,
                         *((2_411, 30) if args.rehearse else (20_011, 40)))
    # maf_log at every segment width its geometry chooses
    check_maf_log_shapes(torch, dev, args.seed + 31, results, tuple(
        (n, 101) for n, _ in MAF_LOG_NS) if args.rehearse else MAF_LOG_NS)
    log(f"[scan check] done in {time.perf_counter() - t0:.1f} s")

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
    # past 806 individuals on float32 gl and 1,210 on bfloat16 kernel B
    # reads its cells unstaged (sums_grad_geometry)
    check_maf_shapes(torch, dev, results, args.seed,
                     101 if args.rehearse else 5_003, Ns=(1_300,))
    log(f"[macro shapes] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gl, dist, freq, F0, a0 = simulate(args.sites, N, args.seed)
    log(f"[main] inputs simulated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_kernels(torch, dev, gl, dist, freq, F0, a0, "main shape", results,
                  probes=True, bf16=True)
    # the scan tier's kernels at the scan path's shape (the main path's
    # data in float64): their lines keep this shape's times
    check_log_kernels(torch, dev, gl, dist, freq, F0, a0, "main shape",
                      results)
    check_log32_kernels(torch, dev, gl, dist, freq, F0, a0, "main shape",
                        results)
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
    # the scan tier's kernels at the scan_restart path's shape: the same
    # replicates' float64 emissions in R * N columns, the chain's own
    # block geometry there; the lines keep the main shape's times and
    # take the larger error
    t0 = time.perf_counter()
    flat = flatten_states(stack_restart_states(
        torch.as_tensor(gl_c).to(dev, torch.float64), R, args.seed + 5,
        device=dev))
    label_r, at_restart = f"restart shape R={R}", {}
    check_log_kernels(torch, dev, gl_c, dist_c, None, flat.indF, flat.alpha,
                      label_r, at_restart, e_prob=flat.e_prob)
    check_log32_kernels(torch, dev, gl_c, dist_c, None, flat.indF,
                        flat.alpha, label_r, at_restart, e_prob=flat.e_prob)
    del flat
    for name, r in at_restart.items():
        mine = results[name]
        mine["max_abs_err"] = max(mine["max_abs_err"], r["max_abs_err"])
        by = mine.setdefault("ms_by_shape", {"main shape": mine["ms"]})
        by[label_r] = r["ms"]
    log(f"[scan restart shape] done in {time.perf_counter() - t0:.1f} s")
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
    # the float64 scan tier (the JAX package's default) on the same data
    t0 = time.perf_counter()
    paths["scan"] = run_scan_path(torch, dev, gl, dist, freq, F0, a0)
    log(f"[scan] path done in {time.perf_counter() - t0:.1f} s")
    # the same on the float32 scan tier (--dtype float32)
    t0 = time.perf_counter()
    paths["scan32"] = run_scan_path(torch, dev, gl, dist, freq, F0, a0,
                                    dtype=torch.float32)
    log(f"[scan32] path done in {time.perf_counter() - t0:.1f} s")
    # the fused tier with a float64 state (--kernel pallas, the JAX CLI's
    # default --dtype): its kernels read float32, held against main
    t0 = time.perf_counter()
    paths["main64"], _ = run_path(
        torch, dev, "main64", gl, dist, freq, F0, a0, 1,
        CHAIN_KERNELS + SLAB_KERNELS + ("maf_macro_slab",), writers=False,
        against=finals["main"], dtype=torch.float64)
    log(f"[main64] path done in {time.perf_counter() - t0:.1f} s")
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
    t0 = time.perf_counter()
    paths["scan_restart"] = run_restart_path(torch, dev, gl_c, dist_c,
                                             freq_c, R, args.seed + 5,
                                             scan=True)
    log(f"[scan_restart] path done in {time.perf_counter() - t0:.1f} s")
    # the scan tier's replicates in the LD modes (--n_rep 4 --freq_est 2
    # --e_prob 2): the haplotype EM of each replicate on its columns
    t0 = time.perf_counter()
    paths["scan_ld_restart"] = run_restart_path(
        torch, dev, gl_c, dist_c, freq_c, 2 if args.rehearse else 4,
        args.seed + 9, scan=True, ld=True)
    log(f"[scan_ld_restart] path done in {time.perf_counter() - t0:.1f} s")
    del gl_c
    if args.against_maf:
        against_maf(args.against_maf)
    counts = {name: sum(c.get(name, 0) for c in paths.values())
              for name in KERNELS}
    log(f"[paths] launches per path: {json.dumps(paths)}")
    if dev.type == "cuda" and min(counts.values()) < 1:
        fail(f"a kernel was launched on no path: {counts}")

    # ---- phase 5: the CLI: on the fused tier one run, three lockstep
    # restarts, the LD path, bfloat16 gl slabs; then one run on the
    # default tier (the float64 scan tier)
    run_cli(dev, args.seed)
    run_cli(dev, args.seed, n_rep=3)
    run_cli(dev, args.seed, ld=True)
    run_cli(dev, args.seed, gl_bf16=True)
    run_cli(dev, args.seed, tier="scan")
    # the three command lines this slice lifted the refusals of
    run_cli(dev, args.seed, tier="scan32")
    run_cli(dev, args.seed, tier="pallas64")
    run_cli(dev, args.seed, n_rep=3, ld=True, tier="scan")

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
        for extra in ("ms_by_shape", "posterior_mode"):
            if extra in r:
                kernels[-1][extra] = r[extra]
    log(f"[total] {time.perf_counter() - t_script:.1f} s from the start to "
        "the result lines (the 1,200 s limit includes the build)")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
