"""Multi-restart protocol: the ngsF-HMM.sh replicate loop in lockstep.

The reference wrapper (reference: ngsF-HMM.sh:9,83-116) runs N_REP=20
independent full EM runs with re-rolled seeds and keeps the replicate
with the highest first-line log-likelihood of ``.indF``. Here the R
replicates are FLATTENED into the column axis of one EM iteration (JAX
models/restart.py, its pallas path): column r * N + i is (replicate r,
individual i), the chain kernels and the batched L-BFGS run once over
all R * N columns, and only the freq M-step segments by replicate. That
holds on both tiers, in a float64 or float32 state: the scan tier
(numerics "log", where the JAX package vmaps its em_iteration over the
replicates instead), with every --freq_est and --e_prob (each replicate's
haplotype EM or site-0 emission update on its own columns), and the
fused one (numerics "pallas", the emission-slab kernels), with --freq_est
0 or 1 and --e_prob 1. Each replicate keeps its own convergence
bookkeeping: one that has converged is frozen while the stragglers
finish, as independent runs would stop at their own pace.

Seeding: replicate r draws its random inits from GslTaus(seed + r)
(the shell wrapper's ``--seed $RANDOM`` is irreproducible by design);
replicate 0 reproduces a single run with ``--seed seed``.
"""

import dataclasses

import numpy as np
import torch

from ..io.gsl_rng import GslTaus
from ..io.init import init_freq, init_indF_alpha
from .em import (EMOptions, EMResult, EMState, _device, _refuse,
                 em_iteration, init_state)
from .hmm import viterbi


def stack_restart_states(gl, n_rep, seed, indF_spec="r", freq_spec="r",
                         alpha_literal=None, freq_est=1, e_prob_calc=1,
                         device="cuda", dtype=None) -> EMState:
    """R independently seeded initial EM states, stacked on axis 0 (JAX
    restart.stack_restart_states).

    indF_spec/freq_spec follow the CLI's init strings
    (parse_args.cpp:248-363); replicate r resolves its random draws with
    GslTaus(seed + r); freq_est / e_prob_calc select the LD inits as for
    one run, so with e_prob_calc 2 each replicate's LD pair emissions come
    from its own freq0. Returns an EMState whose fields have a leading [R]
    axis, on `device` in `dtype` (None: gl's own; em.TIER_DTYPES says
    which types each tier runs)."""
    dev = _device(device)
    gl = torch.as_tensor(gl)
    dtype = gl.dtype if dtype is None else dtype
    gl = gl.to(device=dev, dtype=dtype)
    S, N = gl.shape[0], gl.shape[1]
    states = []
    for r in range(n_rep):
        rng = GslTaus(seed + r)
        indF0, alpha0 = init_indF_alpha(indF_spec, N, rng)
        freq0 = init_freq(freq_spec, S, rng, gl=gl, freq_est=freq_est,
                          device=dev)
        if alpha_literal is not None:
            alpha0 = np.full(N, alpha_literal)
        states.append(init_state(gl, freq0, indF0, alpha0,
                                 e_prob_calc=e_prob_calc, device=dev,
                                 dtype=dtype))
    return EMState(*(torch.stack(xs) for xs in zip(*states)))


def flatten_states(states: EMState) -> EMState:
    """Stacked [R] states -> the flattened state of em_iteration(n_rep=R):
    indF/alpha/ind_lkl [R*N], e_prob [S, R*N, 2], p_ibd [S, R*N], freq
    [R, S] (column r*N + i = replicate r, individual i)."""
    R, S, N = states.e_prob.shape[:3]
    return EMState(
        freq=states.freq,
        indF=states.indF.reshape(R * N),
        alpha=states.alpha.reshape(R * N),
        e_prob=states.e_prob.permute(1, 0, 2, 3).reshape(S, R * N, 2),
        p_ibd=states.p_ibd.permute(1, 0, 2).reshape(S, R * N),
        ind_lkl=states.ind_lkl.reshape(R * N),
    )


def take_replicate(flat: EMState, r: int) -> EMState:
    """Replicate r of a flattened state, as a single run's EMState."""
    R = flat.freq.shape[0]
    N = flat.indF.shape[0] // R
    cols = slice(r * N, (r + 1) * N)
    return EMState(
        freq=flat.freq[r],
        indF=flat.indF[cols],
        alpha=flat.alpha[cols],
        e_prob=flat.e_prob[:, cols].contiguous(),
        p_ibd=flat.p_ibd[:, cols].contiguous(),
        ind_lkl=flat.ind_lkl[cols],
    )


def _freeze(new: EMState, old: EMState, active) -> EMState:
    """Keep converged replicates' state, like an independent run that has
    already left its loop (JAX restart.py:207-216)."""
    R = new.freq.shape[0]
    act = torch.as_tensor(np.asarray(active), device=new.freq.device)
    cols = act.repeat_interleave(new.indF.shape[0] // R)
    return EMState(
        freq=torch.where(act[:, None], new.freq, old.freq),
        indF=torch.where(cols, new.indF, old.indF),
        alpha=torch.where(cols, new.alpha, old.alpha),
        e_prob=torch.where(cols[None, :, None], new.e_prob, old.e_prob),
        p_ibd=torch.where(cols[None, :], new.p_ibd, old.p_ibd),
        ind_lkl=torch.where(cols, new.ind_lkl, old.ind_lkl),
    )


@dataclasses.dataclass
class RestartResult:
    best: EMResult
    best_rep: int
    rep_lkl: np.ndarray  # [R] final total log-likelihoods
    rep_iters: np.ndarray  # [R] iterations each replicate ran
    rep_freq: np.ndarray = None  # [R, S] final allele frequencies


def run_em_restarts(gl, dist, states: EMState, opts: EMOptions,
                    log_callback=None, trace=None,
                    device="cuda") -> RestartResult:
    """Run R lockstep EM replicates; return the argmax-likelihood one (JAX
    restart.run_em_restarts, its flattened route).

    states: EMState with a leading [R] axis (stack_restart_states); the
    run works on a flattened copy, so a caller that passes the stacked
    states without keeping them saves their memory.
    Selection matches ngsF-HMM.sh:97-99 (highest total log-likelihood);
    the winner is decoded with Viterbi.
    log_callback(n_iter, flat_state, tots [R]) and trace(event, **kw) are
    convergence_loop's hooks; they see the flattened state (take_replicate
    picks one replicate out of it).

    The L-BFGS memory is threaded as [m, R*N, 2] and updated every
    iteration, frozen replicates' rows too (their steps are discarded, as
    in the JAX package). best.opt_memory holds the winner's N columns of
    it, the memory a warm single run from best.state takes."""
    from .driver import convergence_loop

    R, N = states.indF.shape
    if R < 2:
        raise ValueError(f"run_em_restarts needs 2 or more replicates, got "
                         f"{R}: one replicate is models/em.run_em")
    # (gl_bf16 changes nothing here: the flattened route reads emission
    # slabs, and its freq M-step float32 gl slabs, as in the JAX package)
    dev = _device(device)
    dtype = states.indF.dtype
    _refuse(opts.freq_est, opts.e_prob_calc, R, opts.numerics,
            opts.block_size, dtype)
    gl = torch.as_tensor(gl).to(device=dev, dtype=dtype)
    dist = torch.as_tensor(dist).to(device=dev, dtype=dtype)
    flat = flatten_states(EMState(*(t.to(dev) for t in states)))
    del states  # the stacked copy goes once the caller holds none either
    warm = opts.warm_mstep and not (opts.indF_fixed and opts.alpha_fixed)
    hold = {"mem": None, "slabs": None}
    opt_iters = []

    def step(st, active):
        st2, stats, hold["slabs"], mem = em_iteration(
            gl, dist, st,
            freq_est=opts.freq_est,
            e_prob_calc=opts.e_prob_calc,
            indF_fixed=opts.indF_fixed,
            alpha_fixed=opts.alpha_fixed,
            numerics=opts.numerics,
            n_rep=R,
            prep_slabs=hold["slabs"],
            return_prep=True,
            opt_memory=hold["mem"],
            return_opt=True,
        )
        if warm:
            hold["mem"] = mem
        opt_iters.append(stats.opt_iters)
        return (st2, st2.ind_lkl.cpu().numpy(),
                stats.fwbw_maxdiff.cpu().numpy())

    flat, bk, _ = convergence_loop(
        step, flat, opts, n_ind=N, n_rep=R, freeze=_freeze,
        log_callback=log_callback, trace=trace, track_history=True,
    )
    tot, iters_done = bk.tot, bk.iters_done
    best_rep = int(np.argmax(tot))
    best_state = take_replicate(flat, best_rep)
    rep_freq = flat.freq.cpu().numpy()
    del flat  # the winner's columns are copied out: the rest can go
    mem = hold["mem"]
    if mem is not None:
        cols = slice(best_rep * N, (best_rep + 1) * N)
        S_m, Y_m, valid, head = mem
        mem = (S_m[:, cols].contiguous(), Y_m[:, cols].contiguous(),
               valid[:, cols].contiguous(), head[cols].contiguous())
    path, _ = viterbi(best_state.e_prob, dist, best_state.indF,
                      best_state.alpha, compat=opts.viterbi_compat)
    best = EMResult(
        state=best_state,
        path=path.cpu().numpy(),
        tot_lkl=float(tot[best_rep]),
        n_iters=int(iters_done[best_rep]),
        converged=bool(iters_done[best_rep] < opts.max_iters),
        lkl_history=[float(h[best_rep]) for h in bk.history],
        opt_iters=opt_iters,
        opt_memory=mem,
    )
    return RestartResult(best=best, best_rep=best_rep, rep_lkl=tot.copy(),
                         rep_iters=iters_done.copy(), rep_freq=rep_freq)
