"""Batched box-constrained L-BFGS for the per-individual (F, alpha) M-step.

The reference hands each individual's 2-parameter problem to a serial
L-BFGS-B 2.1 (f2c) with central-difference gradients, re-running a full
forward pass per function evaluation (reference: EM.cpp:423-439,
shared/bfgs.cpp:83-138, MVAL=10 / FACTR=1e6 / PGTOL=1e-3 at bfgs.h:23-25).

Here ALL individuals are optimised simultaneously by one projected L-BFGS
whose state carries a batch axis: every line-search probe is a single
batched value-and-grad evaluation (one HMM pass over all individuals),
with analytic Fisher-identity gradients. Individuals converge
independently via masking. The full step t = 1 is probed first (it is
usually accepted, so one pass per outer iteration covers both the search
and the next gradient); rejections backtrack by safeguarded quadratic
interpolation.

Versus upstream L-BFGS-B: gradient projection with an active-set-masked
two-loop recursion and a projected-path Armijo backtracking search rather
than the exact generalized-Cauchy-point + subspace minimisation; stopping
criteria (projected-gradient inf-norm <= pgtol, relative f-decrease <=
factr * eps_mach) match. Fixed parameters are expressed as the reference
does, by pinning lower == upper == x0 (EM.cpp:429-436).

A transliteration of ngsf_hmm_tpu/models/lbfgsb.py (_two_loop,
_lbfgsb_core with its Python-loop backend) to torch tensors: the same
update rules, constants and op order.
"""

from typing import Callable, NamedTuple

import torch

MVAL = 10
FACTR = 1e6
PGTOL = 1e-3
EPS_MACH = 2.220446049250313e-16
# Line-search round cap (the reference's dcsrch caps at 20 evaluations).
# The noise-floor gate below (not this cap) is what retires rows whose
# achievable decrease is below the dtype's resolution; the cap only
# bounds GENUINE backtracks.
MAX_LS = 10
ARMIJO_C1 = 1e-4


class _State(NamedTuple):
    x: torch.Tensor  # [B, n]
    f: torch.Tensor  # [B]
    g: torch.Tensor  # [B, n]
    S: torch.Tensor  # [m, B, n]  history of steps s_j
    Y: torch.Tensor  # [m, B, n]  history of grad diffs y_j
    valid: torch.Tensor  # [m, B] bool
    head: torch.Tensor  # [B] int32, PER-ROW next ring-buffer slot
    active: torch.Tensor  # [B] bool
    it: int


def _slot_gather(A, j):
    """A [m, B, ...], j [B] -> A[j[b], b] for every row b."""
    j = j.long()
    if A.ndim == 3:
        idx = j[None, :, None].expand(1, A.shape[1], A.shape[2])
        return torch.gather(A, 0, idx)[0]
    return torch.gather(A, 0, j[None, :])[0]


def _two_loop(g, S, Y, valid, head, m):
    """Batched two-loop recursion: d = -H g restricted to valid history,
    newest stored pair first (head-1, head-2, ... PER ROW: each row
    advances its own ring buffer only when it stores a pair, so a row's
    trajectory is independent of how rows are batched together)."""
    eps = 1e-12
    one = torch.ones((), dtype=g.dtype, device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)

    q = g
    alphas = []
    for i in range(m):
        j = (head - 1 - i) % m
        s = _slot_gather(S, j)
        y = _slot_gather(Y, j)
        v = _slot_gather(valid, j)
        sy = torch.sum(s * y, dim=-1)
        rho = torch.where(v & (sy > eps),
                          1.0 / torch.where(sy == 0, one, sy), zero)
        a = rho * torch.sum(s * q, dim=-1)
        vm = torch.where(v, one, zero)[:, None]
        q = q - a[:, None] * y * vm
        alphas.append((a, s, y, vm, rho))

    # H0 scaling from the newest stored pair
    j_new = (head - 1) % m
    s_n = _slot_gather(S, j_new)
    y_n = _slot_gather(Y, j_new)
    v_n = _slot_gather(valid, j_new)
    yy = torch.sum(y_n * y_n, dim=-1)
    sy = torch.sum(s_n * y_n, dim=-1)
    gamma = torch.where(v_n & (yy > eps),
                        sy / torch.where(yy == 0, one, yy), one)
    gamma = torch.clamp(gamma, 1e-8, 1e8)
    r = gamma[:, None] * q

    for a, s, y, vm, rho in reversed(alphas):
        b = rho * torch.sum(y * r, dim=-1)
        r = r + (a - b)[:, None] * s * vm
    return -r


def _lbfgsb_core(
    x0,
    lower,
    upper,
    m: int,
    max_iters: int,
    pgtol: float,
    factr: float,
    value_and_grad: Callable,
    warm=None,
    noise_eps=None,
    f0g0=None,
):
    """Projected L-BFGS; see `lbfgsb_minimize` for the argument contract.
    Every probe goes through `value_and_grad`.

    f0g0: optional precomputed (f, g) AT x0 (after the box clip); the
    values must equal what value_and_grad(x0) would return, and the
    trajectory is then unchanged.

    warm: optional curvature memory (S [m, B, n], Y, valid [m, B],
    head [B]) from a previous solve of a NEARBY objective (the EM outer
    loop). The first two-loop direction is then quasi-Newton instead of
    steepest descent. Returns (x, f, it, (S, Y, valid, head)). The
    ring-buffer head is PER-ROW [B] and advances only when that row
    stores a curvature pair."""
    B, n = x0.shape
    dtype, dev = x0.dtype, x0.device
    x0 = torch.clamp(x0, lower, upper)

    f0, g0 = f0g0 if f0g0 is not None else value_and_grad(x0)

    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)

    def proj(x):
        return torch.clamp(x, lower, upper)

    def pg_norm(x, g):
        return torch.amax(torch.abs(proj(x - g) - x), dim=-1)

    # dtype-aware noise floor: in f32 at HMM likelihood scale (|f| ~ 1e4
    # per individual) neither PGTOL = 1e-3 nor factr*eps(f64) relative
    # decreases are resolvable; a row whose achievable decrease is below
    # ~8 ulps of f is done. noise_eps overrides when the OBJECTIVE is
    # computed at a coarser precision than x0.
    eps_dt = float(noise_eps or torch.finfo(dtype).eps)
    noise_rel = max(factr * EPS_MACH, 8.0 * eps_dt)

    if warm is None:
        S0 = torch.zeros((m, B, n), dtype=dtype, device=dev)
        Y0 = torch.zeros((m, B, n), dtype=dtype, device=dev)
        valid0 = torch.zeros((m, B), dtype=torch.bool, device=dev)
        head0 = torch.zeros((B,), dtype=torch.int32, device=dev)
    else:
        S0, Y0, valid0, head_in = warm
        # per-row heads; accept a scalar broadcast
        head0 = torch.zeros((B,), dtype=torch.int32, device=dev) + \
            torch.as_tensor(head_in, dtype=torch.int32, device=dev)

    st = _State(
        x=x0, f=f0, g=g0, S=S0, Y=Y0, valid=valid0, head=head0,
        active=pg_norm(x0, g0) > pgtol, it=0,
    )

    # Freeze slack: a coordinate PRACTICALLY at a bound (within 1e-9 of
    # the box width) pressing outward behaves as pinned -- the reference
    # Cauchy scan fixes such variables the instant its path touches the
    # bound (bfgs.cpp cauchy_). Widened to the objective's resolution on
    # coarse-precision paths.
    bnd_eps = max(1e-9, eps_dt) * (upper - lower)
    slots = torch.arange(m, dtype=torch.int32, device=dev)

    def body(st: _State):
        # freeze bound-pinned coordinates whose gradient points outward
        at_lo = (st.x <= lower + bnd_eps) & (st.g > 0)
        at_hi = (st.x >= upper - bnd_eps) & (st.g < 0)
        frozen = at_lo | at_hi
        g_eff = torch.where(frozen, zero, st.g)

        d = _two_loop(g_eff, st.S, st.Y, st.valid, st.head, m)
        d = torch.where(frozen, zero, d)
        # fall back to steepest descent when d is not a descent direction
        descent = torch.sum(d * g_eff, dim=-1) < 0
        d = torch.where(descent[:, None], d, -g_eff)
        # Breakpoint of the projected path (first bound any moving
        # coordinate reaches, in step units) -- the batched stand-in for
        # the reference's generalized-Cauchy-point breakpoint scan. The
        # backtracking ladder SNAPS to just under it, and cold
        # steepest-descent steps that overshoot it get one
        # accept-if-better interior probe.
        qn = descent & torch.any(st.valid, dim=0)
        dist_bp = torch.where(
            d > 0, upper - st.x, torch.where(d < 0, st.x - lower, inf)
        )
        t_bp = torch.amin(
            torch.where(d != 0,
                        dist_bp / torch.where(d == 0, one, torch.abs(d)),
                        inf),
            dim=-1,
        ).to(dtype)
        t_first = torch.ones((B,), dtype=dtype, device=dev)

        # Armijo backtracking where EVERY probe is one batched
        # value-and-grad evaluation: the full step t = 1 first; rows that
        # reject backtrack by safeguarded quadratic interpolation
        # (Nocedal & Wright 3.5, clipped into [0.1 t, 0.5 t]).
        gd0 = torch.sum(g_eff * d, dim=-1)  # phi'(0), < 0 on descent

        def probe(t):
            x_c = proj(st.x + t[:, None] * d)
            f_c, g_c = value_and_grad(x_c)
            dec = torch.sum(st.g * (x_c - st.x), dim=-1)
            moved = torch.any(x_c != st.x, dim=-1)
            ok = (
                (f_c <= st.f + ARMIJO_C1 * dec) & moved & torch.isfinite(f_c)
            )
            return x_c, f_c, g_c, ok

        # achievable-decrease noise floor per row
        noise_f = noise_rel * torch.clamp_min(torch.abs(st.f), 1.0)

        x_sp, f_sp, g_sp, ok_sp = probe(t_first)
        acc0 = st.active & ok_sp
        # don't backtrack rows whose IDEAL first-order decrease at the
        # next step is already below the noise floor
        need_rej = st.active & ~ok_sp & (-gd0 * t_first * 0.5 > noise_f)
        # cold rows whose ACCEPTED full step overshot a breakpoint take
        # one interior (just-below-breakpoint) probe and keep the better f
        corner0 = acc0 & ~qn & (t_first > t_bp)
        need = need_rej | corner0

        t, f_t = t_first, f_sp
        x_new = torch.where(acc0[:, None], x_sp, st.x)
        f_new = torch.where(acc0, f_sp, st.f)
        g_new = torch.where(acc0[:, None], g_sp, st.g)
        rounds = 0
        while bool(torch.any(need)):
            # quadratic-fit minimiser, safeguarded into [0.1 t, 0.5 t]
            denom = 2.0 * (f_t - st.f - gd0 * t)
            t_q = torch.where(
                denom > 0.0,
                -gd0 * t * t / torch.where(denom == 0.0, one, denom),
                0.5 * t,
            )
            t_new = torch.clamp(t_q, min=0.1 * t, max=0.5 * t)
            t_new = torch.where(torch.isfinite(t_new), t_new, 0.5 * t)
            # snap to just under the projected path's first breakpoint
            t_new = torch.where(
                (t > t_bp) & (t_new > 0.95 * t_bp), 0.95 * t_bp, t_new
            )
            x_c, f_c, g_c, ok = probe(t_new)
            # accept-if-better: corner-check rows already hold an
            # accepted point in f_new; plain rejected rows hold st.f
            newly = need & ok & (f_c < f_new)
            x_new = torch.where(newly[:, None], x_c, x_new)
            f_new = torch.where(newly, f_c, f_new)
            g_new = torch.where(newly[:, None], g_c, g_new)
            rounds += 1
            need = (
                need & ~ok & (t_new > 1e-12) & (rounds < MAX_LS)
                & (-gd0 * t_new * 0.5 > noise_f)
            )
            t, f_t = t_new, f_c
        # keep previous values for inactive rows
        x_new = torch.where(st.active[:, None], x_new, st.x)
        f_new = torch.where(st.active, f_new, st.f)
        g_new = torch.where(st.active[:, None], g_new, st.g)

        s_vec = x_new - st.x
        y_vec = g_new - st.g
        sy = torch.sum(s_vec * y_vec, dim=-1)
        store = st.active & (sy > 1e-12)
        # per-row ring-buffer write: row b stores into slot head[b] % m
        # and advances ITS head only when it stores
        slot = st.head % m  # [B]
        wmask = (slots[:, None] == slot[None, :]) & store[None, :]  # [m, B]
        S = torch.where(wmask[:, :, None], s_vec[None, :, :], st.S)
        Y = torch.where(wmask[:, :, None], y_vec[None, :, :], st.Y)
        valid = st.valid | wmask
        head = st.head + store.to(torch.int32)

        small_pg = pg_norm(x_new, g_new) <= pgtol
        rel_dec = (st.f - f_new) <= noise_rel * torch.clamp_min(
            torch.maximum(torch.abs(st.f), torch.abs(f_new)), 1.0
        )
        no_move = torch.all(s_vec == 0, dim=-1)
        active = st.active & ~small_pg & ~(rel_dec | no_move)

        return _State(
            x_new, f_new, g_new, S, Y, valid, head, active, st.it + 1
        )

    while bool(torch.any(st.active)) and st.it < max_iters:
        st = body(st)
    return st.x, st.f, st.it, (st.S, st.Y, st.valid, st.head)


def lbfgsb_minimize(
    fun,
    x0,
    lower,
    upper,
    m: int = MVAL,
    max_iters: int = 60,
    pgtol: float = PGTOL,
    factr: float = FACTR,
    value_and_grad=None,
    warm=None,
    return_memory: bool = False,
    noise_eps=None,
    f0g0=None,
):
    """Minimise a batched objective within box bounds.

    fun: x [B, n] -> f [B] (independent per batch row; differentiable by
        torch.autograd). May be None when value_and_grad is given.
    x0, lower, upper: [B, n] tensors
    value_and_grad: optional x -> (f [B], g [B, n]) override with an
        analytic gradient. Every line-search probe is one value-and-grad
        evaluation; there is no separate value-only path.
    warm: optional (S, Y, valid, head) curvature memory returned by a
        previous call (with return_memory=True) on a nearby objective --
        the EM warm start. return_memory: append that tuple to the
        return value.
    f0g0: optional precomputed (f, g) at the box-clipped x0; must equal
        value_and_grad(x0)'s.
    Returns (x_opt [B, n], f_opt [B], n_outer_iters[, memory]).
    """
    if value_and_grad is None:

        def value_and_grad(x):
            x = x.detach().requires_grad_(True)
            f = fun(x)
            (g,) = torch.autograd.grad(f.sum(), x)  # rows are independent
            return f.detach(), g

    out = _lbfgsb_core(
        x0, lower, upper, m, max_iters, pgtol, factr, value_and_grad,
        warm=warm, noise_eps=noise_eps, f0g0=f0g0,
    )
    return out if return_memory else out[:3]
