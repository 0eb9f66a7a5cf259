"""The EM engine: one iteration on the card + a host-side convergence loop.

Redesign of the reference training loop (reference: EM.cpp:27-289): the
per-individual thread fan-out becomes a batch axis, the E-step is one
forward-backward pass over all individuals, the (F, alpha) M-step
optimises ALL individuals simultaneously with a batched box-constrained
L-BFGS on analytic gradients, and the convergence bookkeeping
(EM.cpp:56,75-97) is replicated exactly on the host (models/driver.py).

This module carries the single-device kernel routes:
  - the scan tier (numerics "log", the default; the JAX package's
    --kernel scan, in the state's float64 or float32): the blocked
    log-space chain of models/hmm.py (csrc/log_chain.cu, a kernel of each
    float type) for the E-step and every L-BFGS evaluation, the exact
    log-space est_maf (ops/maf.est_maf, csrc/maf_log.cu) for the freq
    M-step, calc_emission for the emissions; one run or R replicates
    flattened into the columns, each with freq_est 0/1/2 and e_prob_calc
    0/1/2;
  - the fused route (numerics "pallas") (models/hmm_kernels.py, emissions
    built in-kernel from (gl, freq)): one run, e_prob_calc 1, freq_est 1
    (the default; the freq M-step on the est_maf kernels of
    ops/maf_kernels.py) or 0 (allele frequencies held fixed); its gl
    slabs are float32, or bfloat16 under gl_bf16 (half their bytes; the
    kernels upcast at load). A float64 state runs as the JAX package
    runs it: the kernels read float32 (gl slabs, freq, F, alpha), their
    outputs are cast to the state's type, and the emissions and L-BFGS
    stay in it;
  - the emission-slab route (models/hmm_kernels_v1.py), which reads
    state.e_prob: R > 1 replicates flattened into the column axis
    (models/restart.py; freq_est 0/1, e_prob_calc 1), and one run on the
    LD path (e_prob_calc 2, LD emissions; freq_est 2, the two-site
    haplotype EM of ops/haplo.py; or both), where e_prob is not the
    (gl, freq) formula. As in the JAX package, e_prob_calc 0 takes that
    route too, with the plain emissions at init.
Every other option value raises NotImplementedError naming the ROADMAP
item that will bring it.

State layout (site-major, 0-based):
  gl      [S, N, 3]  normalised log genotype likelihoods (read-only)
  dist    [S]        Mb distances; dist[0] = first-site coordinate quirk
  freq    [S]        minor allele frequencies
  indF    [N], alpha [N]
  e_prob  [S, N, 2]  log emissions
  p_ibd   [S, N]     IBD posterior, check_interv-snapped
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import maf_kernels
from ..ops.emissions import calc_emission, emission_probs_linear
from ..ops.haplo import haplo_freq, ld_emissions
from ..ops.hwe import calc_hwe, check_interv, post_prob
from ..ops.maf import est_maf, macro_schedule
from ..utils.constants import ALPHA_MAX, ALPHA_MIN, F_MAX, F_MIN
from . import hmm, hmm_kernels, hmm_kernels_v1
from .hmm import viterbi
from .lbfgsb import MVAL, lbfgsb_minimize


@dataclasses.dataclass(frozen=True)
class EMOptions:
    """Engine flags mirroring the reference CLI (parse_args.cpp:43-68).

    The defaults are the JAX package's: the float64 scan tier (numerics
    "log"); numerics "pallas" is the fused float32 tier. The fields of
    tiers still to come are kept so that callers can name them and be
    refused."""

    freq_est: int = 1
    e_prob_calc: int = 1
    indF_fixed: bool = False
    alpha_fixed: bool = False
    min_iters: int = 10
    max_iters: int = 100
    min_epsilon: float = 1e-5
    viterbi_compat: bool = True
    lkl_check_tol: float = 0.001  # EM.cpp:166-170
    check_fwbw: bool = True
    verbose: int = 1
    # Carry the (F, alpha) M-step's L-BFGS curvature memory across EM
    # iterations: the objective changes little between iterations, so the
    # previous Hessian approximation is a near-perfect preconditioner.
    # The reference cold-starts every iteration (EM.cpp:438); per-M-step
    # ENDPOINTS still agree to the shared PGTOL.
    warm_mstep: bool = True
    block_size: object = None  # blocked torch tier: not ported
    # "log" (the float64 scan tier) or "pallas" (the fused float32 tier)
    numerics: str = "log"
    log_every: int = 0  # --log N cadence (EM.cpp:59-63)
    # Store the fused route's gl slabs in bfloat16 (half their bytes, the
    # dominant ones of every stream). The kernels upcast at load, so only
    # the gl input is quantised (about 2^-9 relative); all the chain and
    # est_maf arithmetic stays float32. The emission-slab routes (restarts,
    # the LD path) read no gl slabs, and the exact freq M-step (N < 32)
    # reads float32 gl, as in the JAX package.
    gl_bf16: bool = False


class EMState(NamedTuple):
    freq: torch.Tensor
    indF: torch.Tensor
    alpha: torch.Tensor
    e_prob: torch.Tensor
    p_ibd: torch.Tensor
    ind_lkl: torch.Tensor


class IterStats(NamedTuple):
    fwbw_maxdiff: torch.Tensor  # scalar
    opt_iters: int


@dataclasses.dataclass
class EMResult:
    state: EMState
    path: np.ndarray  # [S, N] int8 Viterbi path
    tot_lkl: float
    n_iters: int
    converged: bool
    lkl_history: list
    # per-iteration L-BFGS outer-iteration counts, and the final
    # curvature memory (S, Y, valid, head) for callers that carry it on
    opt_iters: list = dataclasses.field(default_factory=list)
    opt_memory: object = None


# numerics -> the float types a state of that tier may have: on the scan
# tier each has its own kernels; the fused tier's kernels run float32 (its
# gl slabs may be bfloat16) whatever the state's type. The one place that
# says so: _refuse holds the entry points and the CLI to it.
TIER_DTYPES = {"log": (torch.float64, torch.float32),
               "pallas": (torch.float32, torch.float64)}


def _refuse(freq_est=1, e_prob_calc=1, n_rep=1, numerics="log",
            block_size=None, dtype=None):
    """Raise for every option value this package does not carry yet.
    dtype: the state's, where known; it must be one of its tier's
    (TIER_DTYPES)."""
    if n_rep < 1:
        raise ValueError(f"n_rep must be >= 1, got {n_rep}")
    if freq_est not in (0, 1, 2):
        raise ValueError(f"freq_est must be 0, 1 or 2, got {freq_est}")
    if e_prob_calc not in (0, 1, 2):
        raise ValueError(f"e_prob_calc must be 0, 1 or 2, got {e_prob_calc}")
    if numerics not in ("log", "pallas"):
        raise NotImplementedError(
            f"numerics {numerics!r} (ROADMAP queue 1: "
            "'models/hmm_blocked.py'); the scan tier 'log' and the fused "
            "kernel tier 'pallas' are ported")
    if (n_rep > 1 and numerics == "pallas"
            and (freq_est not in (0, 1) or e_prob_calc != 1)):
        # the JAX package runs these replicates vmapped on its linear
        # tier (models/restart.py:91-97), which is not ported; the scan
        # tier runs them flattened
        raise NotImplementedError(
            f"n_rep {n_rep} with freq_est {freq_est} / e_prob_calc "
            f"{e_prob_calc} on the fused tier (ROADMAP queue 1: "
            "'models/hmm_blocked.py'); the scan tier runs them")
    if dtype is not None and dtype not in TIER_DTYPES[numerics]:
        raise TypeError(
            f"numerics {numerics!r} runs a float64 or float32 state, got "
            f"{dtype}")
    if block_size:
        raise NotImplementedError(
            "block_size (ROADMAP queue 1: 'models/hmm_blocked.py')")


def _device(device):
    """torch.device for an entry point's device argument. 'cuda' without
    a card raises: nothing here falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev


def init_state(gl, freq0, indF0, alpha0, e_prob_calc=1, device="cuda",
               dtype=None) -> EMState:
    """Initial EM state with emissions from the initial freqs
    (parse_args.cpp:370-387). gl/freq0/indF0/alpha0: tensors or numpy
    arrays; everything is moved to `device` in `dtype` (None: gl's own,
    as in the JAX package). Both tiers run float64 and float32 states
    (TIER_DTYPES): the entry points refuse any other type.

    e_prob_calc == 2: sites >= 1 get LD-conditioned pair emissions
    (parse_args.cpp:373-386) from the corrected pair EM seeded with the
    initial freqs (JAX init_state; the reference's own init call NaNs,
    gen_func.cpp:1160). Under freq_est 0/1 the loop recomputes only site
    0's emission, so these stay for the whole run."""
    _refuse(e_prob_calc=e_prob_calc)
    dev = _device(device)
    gl = torch.as_tensor(gl)
    dtype = gl.dtype if dtype is None else dtype
    gl = gl.to(device=dev, dtype=dtype)
    freq0 = torch.as_tensor(freq0).to(device=dev, dtype=dtype)
    S, N = gl.shape[0], gl.shape[1]
    e_prob = calc_emission(gl, freq0[:, None])  # [S, N, 2]
    if e_prob_calc == 2:
        hap = haplo_freq(gl[:-1], gl[1:], freq0[:-1], freq0[1:],
                         compat=False)  # [S-1, 4]
        e_prob[1:] = ld_emissions(hap, gl, freq0)
    return EMState(
        freq=freq0,
        indF=torch.as_tensor(indF0).to(device=dev, dtype=dtype),
        alpha=torch.as_tensor(alpha0).to(device=dev, dtype=dtype),
        e_prob=e_prob,
        p_ibd=torch.zeros((S, N), dtype=dtype, device=dev),
        ind_lkl=torch.full((N,), -torch.inf, dtype=dtype, device=dev),
    )


def in_loop_emission_form(freq_est, numerics="log", site_sharded=False):
    """Which recompute form ``state.e_prob`` carries AFTER an iteration:
    "linear" = ``log(ops.emissions.emission_probs_linear(...))``, "log" =
    ``ops.emissions.calc_emission``. Whoever rebuilds emissions from
    params alone must use exactly this form. freq_est 0 freezes the init
    form ("log"); freq_est 1 on the fused tier recomputes linearly;
    freq_est 2 recomputes via calc_emission (with e_prob_calc 2, sites
    >= 1 carry the LD pair emissions: JAX em.py:153-165)."""
    if freq_est == 1 and (site_sharded or numerics in ("linear", "pallas")):
        return "linear"
    return "log"


def rebuild_eprob(gl, freq):
    """The in-loop ("linear") emission form at `freq`: log emissions
    [S, N, 2] from log gl [S, N, 3]."""
    return torch.log(
        emission_probs_linear(torch.exp(gl), freq[:, None])).to(gl.dtype)


def em_iteration(
    gl,
    dist,
    state: EMState,
    freq_est: int = 1,
    e_prob_calc: int = 1,
    indF_fixed: bool = False,
    alpha_fixed: bool = False,
    block_size: Optional[int] = None,
    numerics: str = "log",
    n_rep: int = 1,
    prep_slabs=None,
    return_prep: bool = False,
    opt_memory=None,
    return_opt: bool = False,
    defer_emissions: bool = False,
    defer_posteriors: bool = False,
    gl_bf16: bool = False,
):
    """One EM iteration (reference: iter_EM, EM.cpp:139-289).

    numerics "log" (the default): the scan tier in the state's float type,
    _em_iteration_log (JAX em.py with numerics "log", block_size None);
    prep_slabs is ignored and the slabs returned under return_prep are
    None; defer_* and gl_bf16 do not apply.

    numerics "pallas": the fused route, where the chain kernels compute
    the emissions in-kernel from (gl, freq). With freq_est 0 the emissions stay those of the initial
    freq (state.freq and state.e_prob pass through untouched). With
    freq_est 1 the freq M-step reads the gl slabs and the RAW posterior
    slab of this iteration's E-step: est_maf_slab (macro-stepped) where
    macro_schedule(N) gives a schedule, else est_maf_exact on the snapped
    posterior (N < 32).

    prep_slabs / return_prep: thread the gl slabs + dist compact across
    iterations (they are constants of the run). prep_slabs is the
    (g0, g2, dc) tuple a previous call returned, or (g0, g2, dc, f0, f2)
    with the float32 slabs of the exact freq M-step under gl_bf16;
    return_prep=True makes the return (state, stats, slabs). The slabs
    keep their dtype across iterations.

    gl_bf16: build the gl slabs in bfloat16 (EMOptions.gl_bf16): the chain
    kernels and est_maf_slab run their bfloat16 exports. The exact freq
    M-step (N < 32) reads float32 slabs of the same gl instead (JAX builds
    float32 gl tiles for its _run there), so its freq, for the same
    posterior, equals the float32 route's bit for bit. The emission-slab
    routes below read no gl slabs: gl_bf16 changes nothing there.

    opt_memory / return_opt: thread the (F, alpha) M-step's L-BFGS
    curvature memory ((S, Y, valid, head)) across EM iterations;
    return_opt=True appends the updated memory to the return tuple.

    defer_emissions: skip the per-iteration state.e_prob recompute -- the
    chain kernels build emissions in-kernel from (gl, freq), so inside
    the loop e_prob is write-only; the returned state carries the STALE
    e_prob and run_em rebuilds it (rebuild_eprob, the in-loop form) at
    loop exit.

    defer_posteriors: skip the slab -> [S, N] unpack + check_interv snap
    (nothing in the loop reads the unpacked posterior: both est_maf
    routes read the raw slab, the exact one snapping as it reads); the
    returned state carries the STALE p_ibd and run_em rebuilds it at loop
    exit. The kernels are deterministic, so the rebuilt p_ibd equals the
    one the undeferred loop carries bit for bit on either route.

    n_rep: R > 1 runs R lockstep replicates FLATTENED into the column axis
    (JAX em.py n_rep contract): gl stays [S, N, 3] (shared),
    state.indF/alpha/ind_lkl are [R*N], state.e_prob/p_ibd are [S, R*N, ..]
    with column r*N+i = (replicate r, individual i), state.freq is [R, S],
    and stats.fwbw_maxdiff is [R]. On the fused tier that route reads
    emission slabs (models/hmm_kernels_v1.py) and requires freq_est in
    (0, 1) and e_prob_calc == 1; prep_slabs is then the (g0, g2) gl slab
    pair of the freq M-step (None under freq_est 0) and defer_* do not
    apply. The scan tier runs every freq_est and e_prob_calc so.

    One run with e_prob_calc != 1 or freq_est 2 (the LD path) takes the
    emission-slab route too, with L = N columns (_em_iteration_v1);
    prep_slabs is then the (g0, g2) pair of linear gl planes [S, N] of
    est_maf_rows (freq_est 1; None otherwise) and defer_* do not apply.
    """
    _refuse(freq_est, e_prob_calc, n_rep, numerics, block_size,
            state.indF.dtype)
    if numerics == "log":
        st, stats, mem = _em_iteration_log(
            gl, dist, state, n_rep, freq_est, e_prob_calc, indF_fixed,
            alpha_fixed, opt_memory)
        return ((st, stats) + ((None,) if return_prep else ())
                + ((mem,) if return_opt else ()))
    if n_rep > 1 or e_prob_calc != 1 or freq_est == 2:
        st, stats, slabs, mem = _em_iteration_v1(
            gl, dist, state, n_rep, freq_est, e_prob_calc, indF_fixed,
            alpha_fixed, prep_slabs, opt_memory)
        return ((st, stats) + ((slabs,) if return_prep else ())
                + ((mem,) if return_opt else ()))
    S, N = gl.shape[0], gl.shape[1]
    dtype = gl.dtype

    # ---- E-step: forward-backward posteriors (EM.cpp:147-185)
    if prep_slabs is not None:
        bs2, nb2 = hmm_kernels.pick_geom2(S, N)
        prep2 = hmm_kernels.make_prep2(*prep_slabs[:3], S, N, bs2, nb2)
        exact_gl = tuple(prep_slabs[3:])
    else:
        gl_lin = torch.exp(gl)
        prep2 = hmm_kernels.prepare_gl_inputs(
            gl_lin, dist,
            gl_dtype=torch.bfloat16 if gl_bf16 else torch.float32)
        # the exact freq M-step reads float32 gl (JAX em.py:562-566 runs
        # _run on float32 tiles): keep float32 slabs beside the bf16 ones
        exact_gl = ()
        if gl_bf16 and freq_est == 1 and macro_schedule(N) is None:
            exact_gl = hmm_kernels.gl_slabs(gl_lin, prep2["bs"], prep2["nb"])
        del gl_lin
    fc = hmm_kernels.freq_compact(state.freq, prep2)
    # E-step / M-step merge: when the (F, alpha) M-step will run, the
    # transfer pass is the fused transfer+TANGENT stream -- its primal
    # rows ARE the transfer products (bit for bit), so the posteriors
    # reuse them via A_reps and the M-step's first value-and-grad comes
    # out of the same stream.
    A_g0 = A_reps0 = None
    if not (indF_fixed and alpha_fixed):
        A_g0, A_reps0 = hmm_kernels.transfer_grad_reps_fused(
            state.indF, state.alpha, prep2, fc
        )
    p_raw, ll_f, ll_b, p_slab = hmm_kernels.posteriors_fused(
        state.indF, state.alpha, prep2, fc, A_reps=A_reps0,
        return_p=not defer_posteriors, return_slab=True,
    )
    p_ibd = (state.p_ibd if defer_posteriors
             else check_interv(p_raw.to(dtype)))
    # the combine returns float64 log-likelihoods: compare before the cast
    fwbw_maxdiff = torch.max(torch.abs(ll_f - ll_b))
    ind_lkl = ll_f.to(dtype)

    # ---- M-step 1: per-individual (F, alpha) (EM.cpp:189-206)
    indF, alpha, opt_iters, opt_mem = _mstep_indF_alpha(
        state, indF_fixed, alpha_fixed,
        lambda F, a: hmm_kernels.loglik_value_and_grad_fused(F, a, prep2, fc),
        opt_memory,
        # the E-step's fused stream already evaluated the chain AND its
        # tangents at exactly these params
        seed=lambda: hmm_kernels.grad_from_carries(A_g0, state.indF),
    )

    # ---- M-step 2: per-site freq + emission recompute (EM.cpp:210-272)
    if freq_est == 0:
        # emissions frozen too: the recompute lives inside the
        # reference's freq-est branch
        freq, e_prob = state.freq, state.e_prob
    else:
        if macro_schedule(N) is not None:
            freq = maf_kernels.est_maf_slab(prep2, p_slab).to(dtype)
        else:
            prep_x = dict(prep2, g0=exact_gl[0],
                          g2=exact_gl[1]) if exact_gl else prep2
            freq = maf_kernels.est_maf_exact(prep_x, p_slab,
                                             snap=True).to(dtype)
        e_prob = state.e_prob if defer_emissions else rebuild_eprob(gl, freq)
    new_state = EMState(freq, indF, alpha, e_prob, p_ibd, ind_lkl)
    out = (new_state, IterStats(fwbw_maxdiff, opt_iters))
    if return_prep:
        out = out + ((prep2["g0"], prep2["g2"], prep2["dc"]) + exact_gl,)
    if return_opt:
        out = out + (opt_mem,)
    return out


def _mstep_indF_alpha(state, indF_fixed, alpha_fixed, vag, opt_memory,
                      seed=None):
    """The (F, alpha) M-step (EM.cpp:189-206): one batched box-constrained
    L-BFGS over every row of state.indF / state.alpha. vag(F, alpha) ->
    (ll, dL/dF, dL/dalpha), each [rows]. seed() gives the same triple at
    the entering params without a new stream; it is used for the first
    evaluation when the box clip is a no-op (out-of-box inits take a real
    evaluation). Returns (indF, alpha, opt_iters, opt_memory)."""
    if indF_fixed and alpha_fixed:
        return state.indF, state.alpha, 0, opt_memory
    dtype = state.indF.dtype

    def box(fixed, value, bound):
        return value if fixed else torch.full_like(value, bound)

    x0 = torch.stack([state.indF, state.alpha], dim=-1)
    lo = torch.stack([box(indF_fixed, state.indF, F_MIN),
                      box(alpha_fixed, state.alpha, ALPHA_MIN)], dim=-1)
    hi = torch.stack([box(indF_fixed, state.indF, F_MAX),
                      box(alpha_fixed, state.alpha, ALPHA_MAX)], dim=-1)

    def objective_vag(x):
        L, gF, ga = vag(x[:, 0], x[:, 1])
        return -L.to(dtype), -torch.stack([gF, ga], dim=-1).to(dtype)

    f0g0 = None
    if seed is not None:
        if bool(torch.all((x0 >= lo) & (x0 <= hi))):
            L0, gF0, ga0 = seed()
            f0g0 = (-L0.to(dtype), -torch.stack([gF0, ga0], dim=-1).to(dtype))
        else:
            f0g0 = objective_vag(torch.clamp(x0, lo, hi))
    x_opt, _, opt_iters, opt_mem = lbfgsb_minimize(
        None, x0, lo, hi, value_and_grad=objective_vag,
        warm=opt_memory, return_memory=True, f0g0=f0g0,
    )
    return x_opt[:, 0], x_opt[:, 1], opt_iters, opt_mem


def _em_iteration_v1(gl, dist, state, n_rep, freq_est, e_prob_calc,
                     indF_fixed, alpha_fixed, gl_consts, opt_memory):
    """em_iteration on the emission-slab route (JAX em.py:363-375,
    :451-463): R = n_rep > 1 replicates flattened into the column axis
    (freq M-step :527-542), or one run on the LD path (:546-620). Returns
    (state, stats, gl_consts, opt_memory).

    E-step: the emission-slab chain kernels on exp(state.e_prob), then the
    check_interv snap and fwbw_maxdiff (per replicate when R > 1). (F,
    alpha) M-step: L-BFGS over the R*N rows, every evaluation one transfer
    + tangent stream (the JAX route has no E-step/M-step merge here).
    The emission slabs are rebuilt from state.e_prob every iteration, as
    in the JAX package.

    Replicates: one est_maf per replicate on the gl slabs at this geometry
    (gl_consts) and the replicate's contiguous cut of the posterior slab,
    SNAPPED as the JAX route reads state.p_ibd: est_maf_slab where
    macro_schedule(N) gives a schedule (keyed on N, as the JAX vmap sees
    [S, N]), else est_maf_exact(snap=True); then the replicate's
    emissions, linear -> log, written back into its columns.

    One run: _freq_step_ld."""
    S, N = gl.shape[0], gl.shape[1]
    R, L = n_rep, n_rep * N
    dtype = gl.dtype
    flat = n_rep > 1
    _check_flat(state, S, N, n_rep)

    # ---- E-step: forward-backward posteriors (EM.cpp:147-185)
    bs, nb = hmm_kernels.pick_geom2(S, L)
    prep = hmm_kernels_v1.prepare_inputs(state.e_prob, dist, bs=bs)
    p_raw, ll_f, ll_b, p_slab = hmm_kernels_v1.posteriors_v1(
        state.indF, state.alpha, prep, return_slab=True)
    p_ibd = check_interv(p_raw.to(dtype))
    del p_raw
    fwbw = torch.abs(ll_f - ll_b)
    fwbw_maxdiff = fwbw.reshape(R, N).amax(1) if flat else torch.max(fwbw)
    ind_lkl = ll_f.to(dtype)

    # ---- M-step 1: per-individual (F, alpha) (EM.cpp:189-206)
    indF, alpha, opt_iters, opt_mem = _mstep_indF_alpha(
        state, indF_fixed, alpha_fixed,
        lambda F, a: hmm_kernels_v1.loglik_value_and_grad_v1(F, a, prep),
        opt_memory)
    del prep

    # ---- M-step 2: per-site freq + emission recompute (EM.cpp:210-272)
    if freq_est == 0:
        freq, e_prob = state.freq, state.e_prob
    elif not flat:
        del p_slab
        freq, e_prob, gl_consts = _freq_step_ld(
            gl, state, p_ibd, freq_est, e_prob_calc, gl_consts)
    else:
        gl_lin = torch.exp(gl)
        if gl_consts is None:
            gl_consts = hmm_kernels.gl_slabs(gl_lin, bs, nb)
        # (est_maf reads no distances: the prep's dc stays None)
        prep2 = hmm_kernels.make_prep2(*gl_consts, None, S, N, bs, nb)
        macro = macro_schedule(N) is not None
        freq = torch.empty((R, S), dtype=dtype, device=gl.device)
        e_prob = torch.empty_like(state.e_prob)
        for r in range(R):
            p_r = p_slab[:, :, r * N:(r + 1) * N].contiguous()
            if macro:
                f_r = maf_kernels.est_maf_slab(prep2, check_interv(p_r))
            else:
                f_r = maf_kernels.est_maf_exact(prep2, p_r, snap=True)
            freq[r] = f_r.to(dtype)
            e_prob[:, r * N:(r + 1) * N] = torch.log(
                emission_probs_linear(gl_lin, freq[r][:, None])).to(dtype)
        del gl_lin
    new_state = EMState(freq, indF, alpha, e_prob, p_ibd, ind_lkl)
    return (new_state, IterStats(fwbw_maxdiff, opt_iters), gl_consts,
            opt_mem)


def _check_flat(state, S, N, n_rep):
    """Raise unless an n_rep > 1 state is the flattened one."""
    R, L = n_rep, n_rep * N
    if n_rep > 1 and (tuple(state.indF.shape) != (L,)
                      or tuple(state.freq.shape) != (R, S)):
        raise ValueError(
            f"n_rep {R}: expected a flattened state (indF [{L}], freq "
            f"[{R}, {S}]), got indF {tuple(state.indF.shape)}, freq "
            f"{tuple(state.freq.shape)} (models/restart.flatten_states)")


def _em_iteration_log(gl, dist, state, n_rep, freq_est, e_prob_calc,
                      indF_fixed, alpha_fixed, opt_memory):
    """em_iteration on the scan tier (JAX em.py with numerics "log",
    block_size None), in the state's float type (float64 or float32);
    returns (state, stats, opt_memory).

    E-step: hmm.posteriors (log_block_transfer, log_combine, log_sweep) on
    state.e_prob, then the check_interv snap and fwbw_maxdiff (from the
    combine's float64 log-likelihoods; ind_lkl is cast to the state's
    type, as JAX carries it). (F, alpha) M-step: L-BFGS over the columns,
    every evaluation hmm.loglik_value_and_grad (the same three kernels,
    the sweep summing the gradient), cold first evaluation as in the JAX
    package. freq M-step (_freq_step_log): freq_est 0 freezes freq and
    e_prob.

    n_rep = R > 1: R replicates flattened into the columns (models/
    restart.py). The chain and the L-BFGS rows are per column, so each
    replicate gets what it gets alone; replicate r's freq M-step
    (_freq_step_log, every freq_est and e_prob_calc) reads its own freq,
    emissions and columns of the posterior (in place) and writes its freq
    and its columns of the emissions. The JAX package vmaps em_iteration
    over the replicates instead (restart.py:180-195)."""
    S, N = gl.shape[0], gl.shape[1]
    R = n_rep
    _check_flat(state, S, N, n_rep)

    # ---- E-step: forward-backward posteriors (EM.cpp:147-185)
    p_raw, ll_f, ll_b = hmm.posteriors(state.e_prob, dist, state.indF,
                                       state.alpha)
    p_ibd = check_interv(p_raw)
    del p_raw
    fwbw = torch.abs(ll_f - ll_b)
    fwbw_maxdiff = fwbw.reshape(R, N).amax(1) if R > 1 else torch.max(fwbw)
    ind_lkl = ll_f.to(state.indF.dtype)

    # ---- M-step 1: per-individual (F, alpha) (EM.cpp:189-206)
    indF, alpha, opt_iters, opt_mem = _mstep_indF_alpha(
        state, indF_fixed, alpha_fixed,
        lambda F, a: hmm.loglik_value_and_grad(F, a, state.e_prob, dist),
        opt_memory)

    # ---- M-step 2: per-site freq + emission recompute (EM.cpp:210-272)
    if freq_est == 0:
        freq, e_prob = state.freq, state.e_prob
    elif R > 1:
        freq = torch.empty_like(state.freq)
        e_prob = torch.empty_like(state.e_prob)
        for r in range(R):
            cols = slice(r * N, (r + 1) * N)
            freq[r], e_prob[:, cols] = _freq_step_log(
                gl, state.freq[r], state.e_prob[:, cols], p_ibd[:, cols],
                freq_est, e_prob_calc)
    else:
        freq, e_prob = _freq_step_log(gl, state.freq, state.e_prob, p_ibd,
                                      freq_est, e_prob_calc)
    new_state = EMState(freq, indF, alpha, e_prob, p_ibd, ind_lkl)
    return new_state, IterStats(fwbw_maxdiff, opt_iters), opt_mem


def _freq_step_log(gl, freq, e_prob, p_ibd, freq_est, e_prob_calc):
    """The scan tier's freq M-step (JAX em.py:572-616) of one run (or one
    replicate: its freq [S], emissions and posterior columns [S, N, ..],
    views in place); returns the new (freq, e_prob). freq_est 1: est_maf
    in log space (maf_log) on the snapped posterior, emissions from
    calc_emission (e_prob_calc 1) or only site 0's (e_prob_calc 0 / 2,
    EM.cpp:252's gate); freq_est 2: the two-site haplotype EM
    (_freq_step_haplo)."""
    if freq_est == 2:
        return _freq_step_haplo(gl, freq, e_prob, p_ibd, e_prob_calc)
    freq = est_maf(gl, p_ibd)
    if e_prob_calc == 1:
        return freq, calc_emission(gl, freq[:, None])
    e_prob = e_prob.clone()
    e_prob[0] = calc_emission(gl[0], freq[0])
    return freq, e_prob


def _freq_step_ld(gl, state, p_ibd, freq_est, e_prob_calc, gl_rows):
    """The freq M-step of one run on the emission-slab route; returns
    (freq, e_prob, gl_rows).

    freq_est 1 (JAX em.py:559-565, :582-588): est_maf_rows on the linear
    gl planes gl_rows (built here on first use; run constants) and the
    snapped posterior; the reference's outer gate (EM.cpp:252
    `if(e_prob_calc == 1 || s == 1)`) then recomputes only site 0's
    emission, with calc_emission.

    freq_est 2 (JAX :589-620): the LD haplotype path. Each adjacent pair's
    two-site EM starts from the previous iteration's freqs (Jacobi, where
    the reference goes site by site) on the genotype posteriors under
    calc_hwe(freq, p_ibd); site 0 takes est_maf (log space, EM.cpp:243);
    site s >= 1 takes hap[1] + hap[3] of pair (s-1, s). Emissions: site
    0 plain, sites >= 1 the LD pair emissions (e_prob_calc 2) or plain
    (otherwise), both with calc_emission's log form."""
    if freq_est == 1:
        if gl_rows is None:
            gl_rows = maf_kernels.gl_rows(gl)
        freq = maf_kernels.est_maf_rows(*gl_rows, p_ibd).to(gl.dtype)
        e_prob = state.e_prob.clone()
        e_prob[0] = calc_emission(gl[0], freq[0])
        return freq, e_prob, gl_rows
    return _freq_step_haplo(gl, state.freq, state.e_prob, p_ibd,
                            e_prob_calc) + (gl_rows,)


def _freq_step_haplo(gl, freq_prev, e_prob_prev, p_ibd, e_prob_calc):
    """freq_est 2's freq M-step (JAX em.py:589-620) from the previous
    iteration's freq [S] and the posterior [S, N] (e_prob_prev gives the
    emissions' shape and type), shared by the emission-slab route and the
    scan tier; returns (freq, e_prob)."""
    prior = calc_hwe(freq_prev[:, None], p_ibd)  # [S, N, 3] log
    pp = post_prob(gl, prior)
    del prior
    hap = haplo_freq(pp[:-1], pp[1:], freq_prev[:-1], freq_prev[1:],
                     compat=False)  # [S-1, 4]
    del pp
    freq0 = est_maf(gl[0:1], p_ibd[0:1])
    freq = torch.cat([freq0, hap[:, 1] + hap[:, 3]])
    e_prob = torch.empty_like(e_prob_prev)
    e_prob[0:1] = calc_emission(gl[0:1], freq[0:1, None])
    if e_prob_calc == 2:
        e_prob[1:] = ld_emissions(hap, gl, freq)
    else:
        e_prob[1:] = calc_emission(gl[1:], freq[1:, None])
    return freq, e_prob


def restore_opt_memory(raw, n_cols, dtype, m=None, device="cuda"):
    """Host L-BFGS memory -> device tuple, or None if it does not fit this
    run (different n_ind or m) -- the optimizer then cold-starts.

    raw: (S, Y, valid, head) as host arrays, or None; n_cols: this run's
    batch width."""
    if m is None:
        m = MVAL
    if raw is None:
        return None
    try:
        S, Y, valid, head = raw
    except (TypeError, ValueError):
        return None
    S = np.asarray(S)
    if S.shape != (m, n_cols, 2):
        return None
    head = np.asarray(head, np.int32)
    if head.ndim == 0:  # scalar head -> per-row broadcast
        head = np.full((n_cols,), head, np.int32)
    dev = _device(device)
    return (
        torch.as_tensor(S).to(device=dev, dtype=dtype),
        torch.as_tensor(np.asarray(Y)).to(device=dev, dtype=dtype),
        torch.as_tensor(np.asarray(valid, bool)).to(dev),
        torch.as_tensor(head).to(dev),
    )


def run_em(
    gl,
    dist,
    state: EMState,
    opts: EMOptions,
    log_callback=None,
    trace=None,
    device="cuda",
    opt_memory=None,
) -> EMResult:
    """Full training loop (reference: EM, EM.cpp:27-135), then the Viterbi
    decode.

    gl [S, N, 3] log GLs and dist [S]: tensors or numpy arrays, moved to
    `device`; state: init_state's (moved too).
    log_callback(iter, state, tot_lkl): invoked at the top of every
    iteration like the --log N output rewrites (EM.cpp:59-63).
    trace(event, **kw): optional stdout-parity hook ("iter_start",
    "iter_done").
    opt_memory: L-BFGS memory to start the warm M-step from
    (restore_opt_memory's output).
    """
    from .driver import convergence_loop

    dev = _device(device)
    dtype = state.indF.dtype
    _refuse(opts.freq_est, opts.e_prob_calc, 1, opts.numerics,
            opts.block_size, dtype)
    gl = torch.as_tensor(gl).to(device=dev, dtype=dtype)
    dist = torch.as_tensor(dist).to(device=dev, dtype=dtype)
    state = EMState(*(t.to(dev) for t in state))
    S, N = gl.shape[0], gl.shape[1]

    # the run constants are threaded across iterations: the gl slabs +
    # dist compact (fused route) or the linear gl planes of est_maf_rows
    # (the LD path's freq M-step)
    prep_holder = {"slabs": None}
    # the warm-started M-step's curvature memory, threaded likewise
    warm = opts.warm_mstep and not (opts.indF_fixed and opts.alpha_fixed)
    opt_holder = {"mem": opt_memory if warm else None}
    # on the fused route nothing in the loop reads state.e_prob (the
    # kernels build emissions from (gl, freq)) or the unpacked posterior
    # (est_maf reads the raw slab): defer both to loop exit. The posterior
    # rebuild needs the final iteration's PRE-update params (the E-step
    # runs on the entering state), tracked per step below. verbose >= 7
    # dumps per-iteration state from the trace hook: keep both live there.
    # The emission-slab route (the LD path) reads both: nothing deferred;
    # nor on the scan tier, which threads no slabs either (JAX run_em).
    fused = (opts.numerics == "pallas" and opts.e_prob_calc == 1
             and opts.freq_est != 2)
    defer = fused and opts.freq_est == 1 and opts.verbose < 7
    defer_p = fused and opts.verbose < 7
    prev_params = {"v": None}

    def _rebuild_pibd(st):
        """One posteriors pass at the final iteration's PRE-update params
        (check_interv-snapped): the p_ibd the undeferred loop would
        carry."""
        if prev_params["v"] is None:
            return st
        freq_p, F_p, a_p = prev_params["v"]
        if prep_holder["slabs"] is not None:
            bs2, nb2 = hmm_kernels.pick_geom2(S, N)
            prep2 = hmm_kernels.make_prep2(*prep_holder["slabs"][:3], S, N,
                                           bs2, nb2)
        else:
            prep2 = hmm_kernels.prepare_gl_inputs(
                torch.exp(gl), dist,
                gl_dtype=torch.bfloat16 if opts.gl_bf16 else torch.float32)
        fc = hmm_kernels.freq_compact(freq_p, prep2)
        p, _, _ = hmm_kernels.posteriors_fused(F_p, a_p, prep2, fc)
        return st._replace(p_ibd=check_interv(p.to(dtype)))

    def step(st, active):
        if defer_p:
            prev_params["v"] = (st.freq, st.indF, st.alpha)
        out = em_iteration(
            gl, dist, st,
            freq_est=opts.freq_est,
            e_prob_calc=opts.e_prob_calc,
            indF_fixed=opts.indF_fixed,
            alpha_fixed=opts.alpha_fixed,
            block_size=opts.block_size,
            numerics=opts.numerics,
            prep_slabs=prep_holder["slabs"],
            return_prep=True,
            opt_memory=opt_holder["mem"] if warm else None,
            return_opt=warm,
            defer_emissions=defer,
            defer_posteriors=defer_p,
            gl_bf16=opts.gl_bf16,
        )
        st2, stats, prep_holder["slabs"] = out[0], out[1], out[2]
        if warm:
            opt_holder["mem"] = out[-1]
        opt_iters.append(stats.opt_iters)
        return (st2, st2.ind_lkl.cpu().numpy(),
                stats.fwbw_maxdiff.cpu().numpy())

    log_cb = log_callback
    if log_callback is not None and defer_p and opts.log_every:

        def log_cb(n_iter, st, tot_):
            # the --log dump writes p_ibd: rebuild the deferred posterior
            # only on iterations whose dump actually fires
            if n_iter == 1 or n_iter % opts.log_every == 0:
                st = _rebuild_pibd(st)
            log_callback(n_iter, st, tot_)

    opt_iters = []
    state, bk, _ = convergence_loop(
        step, state, opts, n_ind=N, log_callback=log_cb, trace=trace,
        track_history=True,
    )
    tot = float(bk.tot[0])
    converged = bk.n_iter < opts.max_iters
    if defer and bk.n_iter > 0:
        state = state._replace(e_prob=rebuild_eprob(gl, state.freq))
    if defer_p and bk.n_iter > 0:
        state = _rebuild_pibd(state)

    # ---- Final Viterbi decode (EM.cpp:110-116)
    path, _ = viterbi(
        state.e_prob, dist, state.indF, state.alpha,
        compat=opts.viterbi_compat,
    )
    return EMResult(
        state=state,
        path=path.cpu().numpy(),
        tot_lkl=tot,
        n_iters=bk.n_iter,
        converged=converged,
        lkl_history=bk.history,
        opt_iters=opt_iters,
        opt_memory=opt_holder["mem"],
    )
