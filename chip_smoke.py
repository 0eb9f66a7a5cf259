#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ngsf_hmm_tpu_torch) on one GPU.

    python3 chip_smoke.py

needs one CUDA device and nvcc. It
  1. requires the card and prints its name and power limit,
  2. builds the CUDA kernels from ngsf_hmm_tpu_torch/csrc (set-up time),
  3. holds every kernel against its plain PyTorch version on the card, at a
     shape with a ragged last block and chromosome breaks and at the main
     path's shape, and times both there,
  4. drives the main path at full width -- 1,000,000 sites x 100
     individuals, float32, freq_est 0: init_state -> run_em (min_iters 3,
     max_iters 4, Viterbi) -> the three writers -- with the launch counts
     set to 0 just before and read just after,
  5. runs the CLI once at a small size.
Any failure exits non-zero. The last line printed is
{"ok": true, "device": {...}}; the line before it lists every kernel with
its launches on the main path, its error against the plain version and its
times.

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

# Gates against the plain versions (same arithmetic in the same order; what
# is left is expf/logf against torch.exp/torch.log).
ATOL = 2e-5      # normalised products, ratios, posteriors
LL_RTOL = 2e-6   # log-likelihoods

# Float operations per (site, lane), counted from the CUDA sources
# (emission prologue 25, transition 12, then the product / rescale step).
FLOPS_CELL = {
    "block_transfer_grad": 37 + 112,
    "block_transfer": 37 + 21,
    "bw_sites": 37 + 14,
    "fw_post": 37 + 18,
}

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
}


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
    warm-up (host clock on the CPU rehearsal)."""

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
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps


def check_kernels(torch, dev, gl, dist, freq, F, alpha, label, results):
    """Every kernel's wrapper against its plain version on `dev` at this
    shape; fills results[name] with the error and times. Fails the run on
    any disagreement."""
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
    cells = bs * nb * N
    slab = cells * 4

    def record(name, err, ms, plain_ms, nbytes, flops):
        b_ms, f_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
        if not np.isfinite(err):
            fail(f"{name} [{label}]: non-finite difference")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r.update(ms=ms, plain_ms=plain_ms, bytes=int(nbytes),
                 bound_ms=max(b_ms, f_ms),
                 bound_by="bytes" if b_ms >= f_ms else "operations")
        log(f"[{label}] {name}: max diff {err:.3g}, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms, bytes {nbytes / 1e6:.1f} MB, "
            f"bound {max(b_ms, f_ms):.4f} ms ({r['bound_by']})")

    def finite(name, *ts):
        for t in ts:
            if not bool(torch.isfinite(t).all()):
                fail(f"{name} [{label}]: NaN or inf in the output")

    def common_scale(got, want, off_g, off_w):
        """Both products rescaled to the plain version's exponent: equal
        values whose maxima straddle a power of two normalise apart."""
        return got * torch.exp2(torch.round((off_g - off_w) / hk._LN2)), want

    # ---- kernel 1: transfer + tangents
    k1, ms = timer(lambda: hk._k_block_transfer_grad(*sl, F_t, a_t))
    p1, pms = timer(lambda: hk._block_transfer_grad_plain(*sl, F_t, a_t),
                    reps=1, warm=0)
    finite("block_transfer_grad", k1, p1)
    g, w = common_scale(k1[:12], p1[:12], k1[12], p1[12])
    err = float((g[:4] - w[:4]).abs().max())
    for lo in (4, 8):  # tangents, relative to each lane's largest entry
        scale = w[lo:lo + 4].abs().amax(0).clamp_min(1.0)
        err = max(err, float(((g[lo:lo + 4] - w[lo:lo + 4]).abs()
                              / scale).max()))
    if err > ATOL:
        fail(f"block_transfer_grad [{label}]: max diff {err} > {ATOL}")
    record("block_transfer_grad", err, ms, pms, 2 * slab + 13 * nb * N * 4,
           cells * FLOPS_CELL["block_transfer_grad"])

    # ---- kernel 4: transfer, B = 1 (bit identity with kernel 1) and B = 2
    F1, a1 = F_t[None].contiguous(), a_t[None].contiguous()
    k4, ms = timer(lambda: hk._k_block_transfer(*sl, F1, a1))
    p4, pms = timer(lambda: hk._block_transfer_plain(*sl, F1, a1),
                    reps=1, warm=0)
    finite("block_transfer", k4, p4)
    if dev.type == "cuda":
        prim = torch.cat([k1[0:4], k1[12:13]])
        if not torch.equal(prim, k4[:, 0]):
            fail(f"[{label}] the grad kernel's primal rows are not bit-equal "
                 "to the transfer kernel's output at B = 1")
        log(f"[{label}] grad-kernel primal rows torch.equal transfer kernel "
            "(B = 1): True")
    g, w = common_scale(k4[:4], p4[:4], k4[4], p4[4])
    err = float((g - w).abs().max())
    F2 = torch.stack([F_t, (F_t * 0.7)]).contiguous()
    a2 = torch.stack([a_t, (a_t * 1.5)]).contiguous()
    kb, pb = (hk._k_block_transfer(*sl, F2, a2),
              hk._block_transfer_plain(*sl, F2, a2))
    g, w = common_scale(kb[:4], pb[:4], kb[4], pb[4])
    err = max(err, float((g - w).abs().max()))
    if not torch.equal(kb[:, 0], k4[:, 0]) and dev.type == "cuda":
        fail(f"[{label}] block_transfer: candidate 0 of B = 2 differs from "
             "B = 1")
    if err > ATOL:
        fail(f"block_transfer [{label}]: max diff {err} > {ATOL}")
    record("block_transfer", err, ms, pms, 2 * slab + 5 * nb * N * 4,
           cells * FLOPS_CELL["block_transfer"])

    # ---- cross-block combine
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
    log(f"[{label}] combine_blocks: loglik rel diff {ll_err:.3g}, "
        f"|ll_f - ll_b| max {fwbw:.3g}")
    if err > ATOL or ll_err > LL_RTOL or fwbw > 1e-3:
        fail(f"combine_blocks [{label}]: vectors {err}, logliks {ll_err}, "
             f"fw/bw {fwbw}")
    record("combine_blocks", err, ms, pms, (5 + 4) * nb * N * 4 + 2 * N * 8,
           2 * nb * N * 12)

    # ---- kernel 2: backward ratio slab
    ends = en_k[:, :, 0].transpose(0, 1).contiguous()
    bw_k, ms = timer(lambda: hk._k_bw_sites(*sl, F_t, a_t, ends))
    bw_p, pms = timer(lambda: hk._bw_sites_plain(*sl, F_t, a_t, ends),
                      reps=1, warm=0)
    finite("bw_sites", bw_k, bw_p)
    err = float((bw_k - bw_p).abs().max())
    if err > ATOL:
        fail(f"bw_sites [{label}]: max diff {err} > {ATOL}")
    record("bw_sites", err, ms, pms, 3 * slab + 2 * nb * N * 4,
           cells * FLOPS_CELL["bw_sites"])

    # ---- kernel 3: posterior slab
    starts = st_k[:, :, 0].transpose(0, 1).contiguous()
    po_k, ms = timer(lambda: hk._k_fw_post(*sl, F_t, a_t, starts, bw_k))
    po_p, pms = timer(lambda: hk._fw_post_plain(*sl, F_t, a_t, starts, bw_k),
                      reps=1, warm=0)
    finite("fw_post", po_k, po_p)
    err = float((po_k - po_p).abs().max())
    if err > ATOL:
        fail(f"fw_post [{label}]: max diff {err} > {ATOL}")
    p_sites = hk._unpack_sites2(po_k, prep)
    if not bool(((p_sites >= 0) & (p_sites <= 1)).all()):
        fail(f"fw_post [{label}]: posterior outside [0, 1]")
    record("fw_post", err, ms, pms, 4 * slab + 2 * nb * N * 4,
           cells * FLOPS_CELL["fw_post"])
    del bw_k, bw_p, po_k, po_p, p_sites, k1, p1, k4, p4, kb, pb, prep, sl

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
        log(f"[{label}] viterbi compat={compat}: path mismatches {mism}, "
            f"score rel diff {s_err:.3g}, IBD share "
            f"{float(pk.float().mean()):.4f}")
        if mism or s_err > LL_RTOL:
            fail(f"viterbi [{label}] compat={compat}: {mism} path cells "
                 f"differ, score rel diff {s_err}")
        if compat:
            ms, pms = ms_c, pms_c
        err = max(err, s_err)
        if S > 500_000:
            break  # the per-site plain loop is minutes at this size
    record("viterbi", err, ms, pms, S * N * (8 + 1 + 1 + 1) + S * 4,
           S * N * 40)


def run_main_path(torch, dev, gl, dist, freq, indF0, alpha0):
    """init_state -> run_em -> writers at full width, counts read around
    it. Returns the launch counts."""
    from ngsf_hmm_tpu_torch.io.writers import write_geno, write_ibd, write_indF
    from ngsf_hmm_tpu_torch.models.em import EMOptions, init_state, run_em
    from ngsf_hmm_tpu_torch.utils import cuda_lib
    from ngsf_hmm_tpu_torch.utils.constants import (ALPHA_MAX, ALPHA_MIN,
                                                    F_MAX, F_MIN)

    S, N = gl.shape[0], gl.shape[1]
    opts = EMOptions(freq_est=0, min_iters=3, max_iters=4, verbose=0)
    iters = []

    def trace(event, **kw):
        if event == "iter_done":
            if dev.type == "cuda":
                torch.cuda.synchronize()
            iters.append((kw["dt"], kw["tot_lkl"],
                          cuda_lib.LAUNCHES["block_transfer_grad"]))

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    state = init_state(gl, freq, indF0, alpha0, device=dev)
    res = run_em(gl, dist, state, opts, trace=trace, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_em = time.perf_counter() - t0
    # the outputs (3.4 GB at full size) go under the checkout's build
    # directory, one file at a time
    st = res.state
    to_np = lambda t: t.detach().cpu().numpy()
    scratch = cuda_lib.build_dir()
    scratch.mkdir(parents=True, exist_ok=True)
    sizes = {}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        out = os.path.join(tmp, "smoke")
        for ext, write in (
            ("indF", lambda f: write_indF(
                f, res.tot_lkl, to_np(st.indF), to_np(st.alpha),
                to_np(st.freq))),
            ("ibd", lambda f: write_ibd(
                f, to_np(st.ind_lkl), res.path, to_np(st.p_ibd))),
            ("geno", lambda f: write_geno(
                f, gl.astype(np.float64), to_np(st.freq).astype(np.float64),
                res.path)),
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
            fail(f"main path called plain versions: {plain}")
        missing = [k for k in KERNELS if counts.get(k, 0) < 1]
        if missing:
            fail(f"main path never launched: {missing} (counts {counts})")
    elif not plain:
        fail("rehearsal: no plain version was called")
    if not (opts.min_iters <= res.n_iters <= opts.max_iters
            and len(iters) == res.n_iters):
        fail(f"expected 3 or 4 EM iterations, ran {res.n_iters}")
    h = res.lkl_history
    if not np.all(np.isfinite(h)):
        fail(f"non-finite total log-likelihood: {h}")
    # freq is frozen, so EM is monotone; the optimizer only accepts float32
    # decreases of each individual's objective, and the float32 ind_lkl
    # round at |ll| ~ S: slack = N ulps of float32 at that magnitude
    slack = N * float(np.spacing(np.float32(abs(h[0]) / N)))
    if any(b < a - slack for a, b in zip(h, h[1:])):
        fail(f"total log-likelihood decreased beyond {slack}: {h}")
    indF, alpha = to_np(st.indF), to_np(st.alpha)
    f32 = np.float32
    if not (np.all(indF >= f32(F_MIN)) and np.all(indF <= f32(F_MAX))
            and np.all(alpha >= f32(ALPHA_MIN))
            and np.all(alpha <= f32(ALPHA_MAX))):
        fail("indF / alpha outside their boxes")
    p_ibd = to_np(st.p_ibd)
    if p_ibd.shape != (S, N) or not np.all((p_ibd >= 0) & (p_ibd <= 1)):
        fail("p_ibd not in [0, 1] or of the wrong shape")
    if res.path.shape != (S, N) or not np.isin(res.path, (0, 1)).all():
        fail("Viterbi path not in {0, 1} or of the wrong shape")
    if sizes["geno"] != S * N * 3 * 8:
        fail(f".geno holds {sizes['geno']} bytes, expected {S * N * 24}")
    if sizes["ibd"] < N * (S + 1) + N * S * 9 or sizes["indF"] < S * 9:
        fail(f"output files too small: {sizes}")
    probes = np.diff([0] + [c for _, _, c in iters])
    log(f"[main] S={S} N={N} float32 freq_est 0: init + {res.n_iters} EM "
        f"iterations + Viterbi in {t_em:.2f} s, with writers {t_all:.2f} s")
    for i, ((dt, tot, _), n_str) in enumerate(zip(iters, probes), 1):
        log(f"[main] iteration {i}: {dt:.3f} s, tot_lkl {tot:.3f}, "
            f"transfer+tangent streams {n_str} (E-step 1 + L-BFGS probes "
            f"{n_str - 1}), L-BFGS outer iterations {res.opt_iters[i - 1]}")
    log(f"[main] mean indF {indF.mean():.4f}, mean alpha {alpha.mean():.4f}, "
        f"Viterbi IBD share {res.path.mean():.4f}, mean p_ibd "
        f"{p_ibd.mean():.4f}")
    if dev.type == "cuda":
        log(f"[main] peak torch.cuda.max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[main] launches {counts}; output bytes {sizes}")
    return counts


def run_cli(dev, seed):
    """python -m ngsf_hmm_tpu_torch once at a small size on files made
    with numpy; exit code and outputs checked."""
    S, N = 5000, 12
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
               "--freq_est", "0", "--freq", "0.25", "--indF", "0.1-0.05",
               "--min_iters", "2", "--max_iters", "3", "--out", out,
               "--device", dev.type]
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
        log(f"[cli] exit 0 at S={S} N={N}: {final.strip()}")


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
    args = ap.parse_args()

    import torch

    torch.set_grad_enabled(False)  # nothing here differentiates
    if args.rehearse:
        dev = torch.device("cpu")
        args.sites, args.ind, args.check_sites = 2003, 7, 1501
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

        # ---- phase 2: build
        t0 = time.perf_counter()
        if args.ptxas:
            lib = cuda_lib.build(("-Xptxas", "-v"))
            for name, err in cuda_lib.build_log:
                log(f"[build] {name}:\n{err}")
            os.remove(lib)  # the flag is part of the name: the run below
            #                 builds the library the package itself loads
        cuda_lib.load()
        log(f"[build] {len(cuda_lib.SOURCES)} sources -> "
            f"{cuda_lib.build()} in {time.perf_counter() - t0:.1f} s (set-up)")

    # ---- phase 3: every kernel against its plain version
    results = {}
    t0 = time.perf_counter()
    S_c, N = args.check_sites, args.ind
    gl, dist, freq, F0, a0 = simulate(S_c, N, args.seed + 7, n_chrom=1)
    step = max(2, min(100_000, S_c // 2))
    dist[step::step] = np.inf  # chromosome breaks every ~100k sites
    check_kernels(torch, dev, gl, dist, freq, F0, a0, "check", results)
    del gl
    log(f"[check] done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gl, dist, freq, F0, a0 = simulate(args.sites, N, args.seed)
    log(f"[main] inputs simulated in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_kernels(torch, dev, gl, dist, freq, F0, a0, "main shape", results)
    log(f"[main shape] kernels checked in {time.perf_counter() - t0:.1f} s")

    # ---- phase 4: the main path
    counts = run_main_path(torch, dev, gl, dist, freq, F0, a0)
    del gl

    # ---- phase 5: the CLI
    run_cli(dev, args.seed)

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
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
