"""The EM engine: one iteration on the card + a host-side convergence loop.

Redesign of the reference training loop (reference: EM.cpp:27-289): the
per-individual thread fan-out becomes a batch axis, the E-step is one
forward-backward pass over all individuals, the (F, alpha) M-step
optimises ALL individuals simultaneously with a batched box-constrained
L-BFGS on analytic gradients, and the convergence bookkeeping
(EM.cpp:56,75-97) is replicated exactly on the host (models/driver.py).

This module carries the fused single-device route only: float32, the
chain kernels of models/hmm_kernels.py, allele frequencies held fixed
(freq_est 0), e_prob_calc 1, one replicate. Every other option value
raises NotImplementedError naming the ROADMAP item that will bring it.

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

from ..ops.emissions import calc_emission
from ..ops.hwe import check_interv
from ..utils.constants import ALPHA_MAX, ALPHA_MIN, F_MAX, F_MIN
from . import hmm_kernels
from .hmm import viterbi
from .lbfgsb import MVAL, lbfgsb_minimize


@dataclasses.dataclass(frozen=True)
class EMOptions:
    """Engine flags mirroring the reference CLI (parse_args.cpp:43-68).

    The defaults are those of the one tier this package has (the fused
    float32 kernels with freq held fixed); the fields of tiers still to
    come are kept so that callers can name them and be refused."""

    freq_est: int = 0
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
    numerics: str = "pallas"  # the fused kernel tier (the JAX name)
    log_every: int = 0  # --log N cadence (EM.cpp:59-63)
    gl_bf16: bool = False  # bfloat16 gl slabs: not ported


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


def _refuse(freq_est=0, e_prob_calc=1, n_rep=1, numerics="pallas",
            block_size=None, gl_bf16=False):
    """Raise for every option value this slice does not carry."""
    if freq_est == 1:
        raise NotImplementedError(
            "freq_est 1 (ROADMAP queue 1: 'freq_est 1' slice, est_maf "
            "kernels)")
    if freq_est != 0:
        raise NotImplementedError(
            f"freq_est {freq_est} (ROADMAP queue 1: 'The LD path')")
    if e_prob_calc != 1:
        raise NotImplementedError(
            f"e_prob_calc {e_prob_calc} (ROADMAP queue 1: 'The LD path')")
    if n_rep != 1:
        raise NotImplementedError(
            f"n_rep {n_rep} (ROADMAP queue 1: 'Multi-restart')")
    if numerics != "pallas":
        raise NotImplementedError(
            f"numerics {numerics!r} (ROADMAP queue 1: 'The f64 scan tier' / "
            "'models/hmm_blocked.py'); only the fused kernel tier "
            "'pallas' is ported")
    if block_size:
        raise NotImplementedError(
            "block_size (ROADMAP queue 1: 'models/hmm_blocked.py')")
    if gl_bf16:
        raise NotImplementedError(
            "gl_bf16 (ROADMAP queue 1: 'bf16 gl slabs')")


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
               dtype=torch.float32) -> EMState:
    """Initial EM state with emissions from the initial freqs
    (parse_args.cpp:370-387). gl/freq0/indF0/alpha0: tensors or numpy
    arrays; everything is moved to `device` in `dtype`."""
    if e_prob_calc != 1:
        _refuse(e_prob_calc=e_prob_calc)
    dev = _device(device)
    gl = torch.as_tensor(gl).to(device=dev, dtype=dtype)
    freq0 = torch.as_tensor(freq0).to(device=dev, dtype=dtype)
    S, N = gl.shape[0], gl.shape[1]
    return EMState(
        freq=freq0,
        indF=torch.as_tensor(indF0).to(device=dev, dtype=dtype),
        alpha=torch.as_tensor(alpha0).to(device=dev, dtype=dtype),
        e_prob=calc_emission(gl, freq0[:, None]),
        p_ibd=torch.zeros((S, N), dtype=dtype, device=dev),
        ind_lkl=torch.full((N,), -torch.inf, dtype=dtype, device=dev),
    )


def em_iteration(
    gl,
    dist,
    state: EMState,
    freq_est: int = 0,
    e_prob_calc: int = 1,
    indF_fixed: bool = False,
    alpha_fixed: bool = False,
    block_size: Optional[int] = None,
    numerics: str = "pallas",
    n_rep: int = 1,
    prep_slabs=None,
    return_prep: bool = False,
    opt_memory=None,
    return_opt: bool = False,
    defer_posteriors: bool = False,
    gl_bf16: bool = False,
):
    """One EM iteration (reference: iter_EM, EM.cpp:139-289) on the fused
    route: the chain kernels compute the emissions in-kernel from
    (gl, freq), and with freq_est 0 the emissions stay those of the
    initial freq (state.freq and state.e_prob pass through untouched).

    prep_slabs / return_prep: thread the gl slabs + dist compact across
    iterations (they are constants of the run). prep_slabs is the
    (g0, g2, dc) tuple a previous call returned; return_prep=True makes
    the return (state, stats, slabs).

    opt_memory / return_opt: thread the (F, alpha) M-step's L-BFGS
    curvature memory ((S, Y, valid, head)) across EM iterations;
    return_opt=True appends the updated memory to the return tuple.

    defer_posteriors: skip the slab -> [S, N] unpack + check_interv snap
    (nothing in the loop reads the unpacked posterior when freq is
    fixed); the returned state carries the STALE p_ibd and run_em
    rebuilds it at loop exit.
    """
    _refuse(freq_est, e_prob_calc, n_rep, numerics, block_size, gl_bf16)
    S, N = gl.shape[0], gl.shape[1]
    dtype = gl.dtype

    # ---- E-step: forward-backward posteriors (EM.cpp:147-185)
    if prep_slabs is not None:
        bs2, nb2 = hmm_kernels.pick_geom2(S, N)
        prep2 = hmm_kernels.make_prep2(*prep_slabs, S, N, bs2, nb2)
    else:
        prep2 = hmm_kernels.prepare_gl_inputs(torch.exp(gl), dist)
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
    p_raw, ll_f, ll_b = hmm_kernels.posteriors_fused(
        state.indF, state.alpha, prep2, fc, A_reps=A_reps0,
        return_p=not defer_posteriors,
    )
    p_ibd = (state.p_ibd if defer_posteriors
             else check_interv(p_raw.to(dtype)))
    # the combine returns float64 log-likelihoods: compare before the cast
    fwbw_maxdiff = torch.max(torch.abs(ll_f - ll_b))
    ind_lkl = ll_f.to(dtype)

    # ---- M-step 1: per-individual (F, alpha) (EM.cpp:189-206)
    opt_mem = opt_memory
    if indF_fixed and alpha_fixed:
        indF, alpha = state.indF, state.alpha
        opt_iters = 0
    else:
        def box(fixed, value, bound):
            return value if fixed else torch.full_like(value, bound)

        x0 = torch.stack([state.indF, state.alpha], dim=-1)
        lo = torch.stack([box(indF_fixed, state.indF, F_MIN),
                          box(alpha_fixed, state.alpha, ALPHA_MIN)], dim=-1)
        hi = torch.stack([box(indF_fixed, state.indF, F_MAX),
                          box(alpha_fixed, state.alpha, ALPHA_MAX)], dim=-1)

        def objective_vag(x):
            L, gF, ga = hmm_kernels.loglik_value_and_grad_fused(
                x[:, 0], x[:, 1], prep2, fc
            )
            return -L.to(dtype), -torch.stack([gF, ga], dim=-1).to(dtype)

        # the E-step's fused stream already evaluated the chain AND its
        # tangents at exactly these params: assemble the optimizer's
        # first (value, gradient) from its carries instead of
        # re-streaming. Valid only when the box clip is a no-op;
        # out-of-box inits take a real evaluation.
        if bool(torch.all((x0 >= lo) & (x0 <= hi))):
            L0, gF0, ga0 = hmm_kernels.grad_from_carries(A_g0, state.indF)
            f0g0 = (-L0.to(dtype), -torch.stack([gF0, ga0], dim=-1).to(dtype))
        else:
            f0g0 = objective_vag(torch.clamp(x0, lo, hi))
        x_opt, _, opt_iters, opt_mem = lbfgsb_minimize(
            None, x0, lo, hi, value_and_grad=objective_vag,
            warm=opt_memory, return_memory=True, f0g0=f0g0,
        )
        indF, alpha = x_opt[:, 0], x_opt[:, 1]

    # ---- M-step 2: freq and the emissions are frozen (freq_est 0; the
    # recompute lives inside the reference's freq-est branch)
    new_state = EMState(state.freq, indF, alpha, state.e_prob, p_ibd, ind_lkl)
    out = (new_state, IterStats(fwbw_maxdiff, opt_iters))
    if return_prep:
        out = out + ((prep2["g0"], prep2["g2"], prep2["dc"]),)
    if return_opt:
        out = out + (opt_mem,)
    return out


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

    _refuse(opts.freq_est, opts.e_prob_calc, 1, opts.numerics,
            opts.block_size, opts.gl_bf16)
    dev = _device(device)
    dtype = state.indF.dtype
    gl = torch.as_tensor(gl).to(device=dev, dtype=dtype)
    dist = torch.as_tensor(dist).to(device=dev, dtype=dtype)
    state = EMState(*(t.to(dev) for t in state))
    S, N = gl.shape[0], gl.shape[1]

    # the gl slabs + dist compact are threaded across iterations
    prep_holder = {"slabs": None}
    # the warm-started M-step's curvature memory, threaded likewise
    warm = opts.warm_mstep and not (opts.indF_fixed and opts.alpha_fixed)
    opt_holder = {"mem": opt_memory if warm else None}
    # nothing in the loop reads the unpacked posterior (freq is fixed):
    # defer the slab -> [S, N] unpack + snap to loop exit. The rebuild
    # needs the final iteration's PRE-update params (the E-step runs on
    # the entering state), tracked per step below. verbose >= 7 dumps
    # per-iteration state from the trace hook: keep it live there.
    defer_p = opts.verbose < 7
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
            prep2 = hmm_kernels.make_prep2(*prep_holder["slabs"], S, N,
                                           bs2, nb2)
        else:
            prep2 = hmm_kernels.prepare_gl_inputs(torch.exp(gl), dist)
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
