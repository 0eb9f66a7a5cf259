"""Two-state HMM recursions: the float64 scan tier and the per-site oracle.

The scan tier (reference: shared/HMM.cpp:6-125; the JAX package's
models/hmm.py, lax.scans over the sites) is log-space forward / backward /
posteriors / analytic gradient on a blocked chain: ``forward_loglik``,
``posteriors`` and ``loglik_value_and_grad`` run the three kernels of
csrc/log_chain.cu for CUDA tensors (float64) and their plain versions,
blocked torch loops in the kernels' order, for CPU tensors:

  log_block_transfer  each block's 2x2 log product       [nb, C, 2, 2]
  log_combine         block entry / exit vectors, ll_f, ll_b
  log_sweep           per-site p_ibd, or the gradient's block sums

The per-site loops (``forward``, ``backward``, ``forward_loglik_sites``,
``posteriors_sites``, ``loglik_value_and_grad_sites``) stay as the test
oracle (float64 or float32, small shapes only). ``viterbi`` runs as a CUDA
kernel for CUDA tensors. The fused float32 tier is models/hmm_kernels.py.

Conventions (0-based):
 - e_prob: [S, N, 2]   log emissions, site-major
 - dist:   [S]         distance (Mb) from the previous site; dist[0] is
                       the first site's absolute coordinate
                       (read_data.cpp:199-205 quirk) and chromosome breaks
                       are +inf
 - F, alpha: [N]
 - fw/bw:  [S, N, 2]   log forward/backward values
"""

import math

import torch

from ..ops.logsum import logsum2
from ..ops.transitions import log_q
from ..utils import cuda_lib
from ..utils.cuda_lib import LAUNCHES, PLAIN_CALLS


def _decay(alpha, dist_s):
    """x = exp(-alpha d), 0 at a chromosome break (d = +inf); the masked
    form keeps every derived quantity finite there."""
    is_break = torch.isinf(dist_s)
    d_safe = torch.where(is_break, torch.ones_like(dist_s), dist_s)
    x = torch.exp(-alpha * d_safe)
    return torch.where(is_break, torch.zeros_like(x), x), d_safe, is_break


def _log_trans_elems(F, alpha, dist_s):
    """Log transition entries (lt00, lt01, lt10, lt11) for one step (or,
    with dist_s [S, 1], all steps). T[k,l] = (1-x) q_l + delta x
    (HMM.cpp:130-139)."""
    x, _, _ = _decay(alpha, dist_s)
    one_m = 1.0 - x
    q0 = 1.0 - F
    q1 = F
    return (torch.log(one_m * q0 + x), torch.log(one_m * q1),
            torch.log(one_m * q0), torch.log(one_m * q1 + x))


def forward(e_prob, dist, F, alpha):
    """Log-space forward pass (HMM.cpp:6-28): (fw [S, N, 2], loglik [N])."""
    S = e_prob.shape[0]
    lt00, lt01, lt10, lt11 = _log_trans_elems(F, alpha, dist[:, None])
    lq = log_q(F)
    c0, c1 = lq[:, 0], lq[:, 1]
    fw = torch.empty_like(e_prob)
    for s in range(S):
        n0 = logsum2(c0 + lt00[s], c1 + lt10[s]) + e_prob[s, :, 0]
        n1 = logsum2(c0 + lt01[s], c1 + lt11[s]) + e_prob[s, :, 1]
        fw[s, :, 0], fw[s, :, 1] = n0, n1
        c0, c1 = n0, n1
    return fw, logsum2(c0, c1)


def forward_loglik_sites(F, alpha, e_prob, dist):
    """Forward total log-likelihood [N] only (per-site oracle)."""
    return forward(e_prob, dist, F, alpha)[1]


def backward(e_prob, dist, F, alpha):
    """Log-space backward pass (HMM.cpp:33-60): (bw [S, N, 2], loglik [N]),
    loglik being the backward-side total of the Fw/Bw check
    (EM.cpp:166-170)."""
    S, N = e_prob.shape[0], e_prob.shape[1]
    lt00, lt01, lt10, lt11 = _log_trans_elems(F, alpha, dist[:, None])
    bw = torch.zeros_like(e_prob)
    b0 = torch.zeros(N, dtype=e_prob.dtype, device=e_prob.device)
    b1 = b0.clone()
    for s in range(S - 1, -1, -1):
        # s >= 1: bw[s-1]; s == 0: the sentinel step that folds in site
        # 0's emission (HMM.cpp:40-56 at s=1)
        p0 = logsum2(lt00[s] + e_prob[s, :, 0] + b0,
                     lt01[s] + e_prob[s, :, 1] + b1)
        p1 = logsum2(lt10[s] + e_prob[s, :, 0] + b0,
                     lt11[s] + e_prob[s, :, 1] + b1)
        if s > 0:
            bw[s - 1, :, 0], bw[s - 1, :, 1] = p0, p1
        b0, b1 = p0, p1
    lq = log_q(F)
    return bw, logsum2(b0 + lq[:, 0], b1 + lq[:, 1])


def posteriors_sites(e_prob, dist, F, alpha):
    """Forward-backward E-step (per-site oracle of ``posteriors``):
    (p_ibd [S, N], loglik_fw [N], loglik_bw [N])."""
    fw, ll_f = forward(e_prob, dist, F, alpha)
    bw, ll_b = backward(e_prob, dist, F, alpha)
    p_ibd = torch.exp(fw[:, :, 1] + bw[:, :, 1] - ll_f[None, :])
    return p_ibd, ll_f, ll_b


def loglik_value_and_grad_sites(F, alpha, e_prob, dist):
    """Analytic (loglik, dL/dF, dL/dalpha), each [N], via forward-backward
    and the Fisher identity (per-site oracle of ``loglik_value_and_grad``)

      dL/dtheta = sum_s sum_{k,l} xi_s(k,l) d(log T_s[k,l])/dtheta
                + sum_k gamma_init(k) d(log q[k])/dtheta,

    division-free: xi_s(k,l) d(log T)/dtheta = u_s(k,l) dT/dtheta with
    u_s(k,l) = exp(fw_{s-1}[k] + e_s[l] + bw_s[l] - L), so parameters
    pinned at the box bounds never produce 0/0. With x = exp(-alpha d),
    dx = d x (both 0 at chromosome breaks):
      dT/dF  = (1-x) * [[-1, 1], [-1, 1]]
      dT/da  = dx * [[-F, F], [1-F, -(1-F)]]
    """
    fw, L = forward(e_prob, dist, F, alpha)
    bw, _ = backward(e_prob, dist, F, alpha)

    lq = log_q(F)  # [N, 2]
    fw_prev = torch.cat([lq[None], fw[:-1]])

    x, d_safe, is_break = _decay(alpha[None, :], dist[:, None])  # [S, N]
    dx = torch.where(is_break, torch.zeros_like(x), d_safe * x)
    one_m = 1.0 - x
    Fb = F[None, :]

    b = e_prob + bw - L[None, :, None]  # [S, N, 2]
    u00 = torch.exp(fw_prev[:, :, 0] + b[:, :, 0])
    u01 = torch.exp(fw_prev[:, :, 0] + b[:, :, 1])
    u10 = torch.exp(fw_prev[:, :, 1] + b[:, :, 0])
    u11 = torch.exp(fw_prev[:, :, 1] + b[:, :, 1])

    gF = (one_m * (-u00 + u01 - u10 + u11)).sum(0)
    ga = (dx * (Fb * (u01 - u00) + (1.0 - Fb) * (u10 - u11))).sum(0)

    # Initial-distribution term (dq0/dF = -1, dq1/dF = +1).
    T00_0 = one_m[0] * (1.0 - F) + x[0]
    T01_0 = one_m[0] * F
    T10_0 = one_m[0] * (1.0 - F)
    T11_0 = one_m[0] * F + x[0]
    eb0 = torch.exp(b[0])  # [N, 2]
    w0 = T00_0 * eb0[:, 0] + T01_0 * eb0[:, 1]
    w1 = T10_0 * eb0[:, 0] + T11_0 * eb0[:, 1]
    return L, gF + (w1 - w0), ga


# ---------------------------------------------------------------------------
# The scan tier: the blocked log-space chain (csrc/log_chain.cu)
# ---------------------------------------------------------------------------

# (block, column) lanes the geometry aims for: one wave of the lane
# kernels' resident thread slots on a 132-SM card (the CTAs an SM their
# launch bounds ask for); fewer blocks shorten log_combine's serial walk
LOG_LANES_TARGET = 132 * cuda_lib.LOG_CHAIN_CTAS * cuda_lib.LOG_CHAIN_THREADS
LOG_MIN_BS = 32  # shortest within-block chain worth a lane
# log_sweep parks the sites' log transitions for its backward pass (32
# bytes of float64 scratch a site and column more than computing them
# again) while its whole scratch takes at most this share of the card's
# free memory
LOG_PARK_SHARE = 0.5


def log_geometry(S, C):
    """(bs, nb) of the blocked chain for S sites and C columns: nb blocks of
    bs sites, nb * C lanes at most LOG_LANES_TARGET (but one block at
    least), bs at least LOG_MIN_BS (one block below that), every block
    holding at least one site (the last one the rest)."""
    nb = max(1, min(S // LOG_MIN_BS, LOG_LANES_TARGET // C))
    bs = -(-S // nb)
    return bs, -(-S // bs)


def _log_blocks(e_prob, dist, bs, nb):
    """The plain versions' padded views: emissions [nb, bs, C, 2] and
    distances [nb, bs]; a pad site has e = 0 and d = 0, the identity in
    log space, so it is an exact no-op of every step."""
    S, C = e_prob.shape[0], e_prob.shape[1]
    pad = nb * bs - S
    e = torch.cat([e_prob, e_prob.new_zeros((pad, C, 2))])
    d = torch.cat([dist, dist.new_zeros(pad)])
    return e.view(nb, bs, C, 2), d.view(nb, bs)


def _log_step(v0, v1, t, e0, e1):
    """One forward step of the JAX scan (hmm.py:forward) from (v0, v1)."""
    t00, t01, t10, t11 = t
    return (logsum2(v0 + t00, v1 + t10) + e0,
            logsum2(v0 + t01, v1 + t11) + e1)


# log_block_transfer's linear chain (csrc/log_chain.cu, the LX_ constants):
# each entry is m * 2^E with m in [1, 2) (or 0, with E = _LX_EZERO) and an
# integer E, so nothing flushes while the log-space chain stays finite
_LX_EZERO = -(1 << 29)  # the exponent of a zero entry or transition
_LX_EFLOOR = -(1 << 27)  # a nonzero entry's exponent saturates here
_LX_DROP = 60  # a term 2^-61 of the other is below its half ulp: dropped
_LX_SPLIT = -708.0  # emission gaps below it keep their exponent apart
_LX_GAP_MIN = -1048576.0  # (2^20 nats) wider gaps count as this one
_LN2 = 0.6931471805599453
_INV_LN2 = 1.4426950408889634
_LN2_HI = 6.93147180369123816490e-01  # 32 bits: j * _LN2_HI is exact
_LN2_LO = 1.90821492927058770002e-10
_MANT = (1 << 52) - 1
_ONE = 1023 << 52


def _lx_norm(v):
    """v (float64, >= 0, normal or 0) as (m in [1, 2) or 0, its binary
    exponent, v == 0): exact bit operations."""
    b = v.view(torch.int64)
    ex = b >> 52
    zero = ex == 0
    m = ((b & _MANT) | _ONE).view(torch.float64)
    return torch.where(zero, torch.zeros_like(m), m), ex - 1023, zero


def _lx_trans(T):
    """A transition (>= 0, subnormal too) as (m, tau): m in [1, 2) and
    tau its exponent, or (0, _LX_EZERO)."""
    sub = (T > 0) & (T < 2.0 ** -1022)
    m, ex, zero = _lx_norm(torch.where(sub, T * 2.0 ** 54, T))
    ex = ex - torch.where(sub, 54, 0)
    return m, torch.where(zero, _LX_EZERO, ex)


def _lx_pow2(k):
    """2^k for integer k <= 0 (exact), 0 below -_LX_DROP."""
    b = (k.clamp_min(-_LX_DROP) + 1023) << 52
    return torch.where(k < -_LX_DROP, 0.0, b.view(torch.float64))


def _lx_emissions(e0, e1):
    """A site's emissions as (offset, w [..., 2], j [..., 2]): the larger
    one is the offset and its factor 1 (ties: state 0), the other's factor
    w 2^j = exp(e_other - offset), with j = 0 but for gaps below
    _LX_SPLIT (Cody-Waite: w in (1/2, 1]); both factors 0 and the offset
    0 where both are -inf."""
    first = e0 >= e1
    hi = torch.where(first, e0, e1)
    lo = torch.where(first, e1, e0)
    dead = hi == -torch.inf
    hs = torch.where(dead, 0.0, hi)
    g = lo - hs
    split = (g < _LX_SPLIT) & (g > -torch.inf)
    gc = g.clamp_min(_LX_GAP_MIN)
    j = torch.trunc(gc * _INV_LN2)
    w = torch.where(split, torch.exp((gc - j * _LN2_HI) - j * _LN2_LO),
                    torch.exp(g))
    j = torch.where(split, j.to(torch.int64), 0)
    one = (~dead).to(e0.dtype)
    zero = torch.zeros_like(j)
    return (hs, torch.stack([torch.where(first, one, w),
                             torch.where(first, w, one)], -1),
            torch.stack([torch.where(first, zero, j),
                         torch.where(first, j, zero)], -1))


def _lx_step(rm, re, tm, te, w, j):
    """The four entries after a site, each [..., 2, 2] (row k, state l):
    entry (k, l) from the row's entries (rm, re)[k, 0] and [k, 1], the
    transitions (tm, te)[0, l] and [1, l] and state l's emission factor
    (w, j)[l] [..., 2]: the larger of the two products keeps its
    exponent, the other is scaled to it (dropped 2^-61 below), the sum
    times w, renormalised."""
    P0 = re[..., :, 0, None] + te[..., None, 0, :]
    P1 = re[..., :, 1, None] + te[..., None, 1, :]
    Pm = torch.maximum(P0, P1)
    s = ((rm[..., :, 0, None] * tm[..., None, 0, :]) * _lx_pow2(P0 - Pm)
         + (rm[..., :, 1, None] * tm[..., None, 1, :]) * _lx_pow2(P1 - Pm))
    m, ex, zero = _lx_norm(s * w[..., None, :])
    E = (Pm + j[..., None, :] + ex).clamp_min(_LX_EFLOOR)
    return m, torch.where(zero, _LX_EZERO, E)


def _log_block_transfer_plain(e_prob, dist, F, alpha, bs, nb):
    """Plain version of csrc/log_chain.cu's k_log_block_transfer, in its
    order: a block's 2x2 product in linear float64, each entry carrying
    its own binary exponent, each site's larger log emission summed into
    a lane offset, logs once at the block's end (the four entries of a
    lane as one [nb, C, 2, 2] tensor)."""
    PLAIN_CALLS["log_block_transfer"] += 1
    e, d = _log_blocks(e_prob, dist, bs, nb)
    C = F.shape[0]
    eye = torch.eye(2, dtype=e.dtype, device=e.device).expand(nb, C, 2, 2)
    rm = eye.clone()
    re = torch.where(eye == 1.0, 0, _LX_EZERO)
    off = torch.zeros((nb, C), dtype=e.dtype, device=e.device)
    q0 = 1.0 - F
    for j in range(bs):
        x, _, _ = _decay(alpha, d[:, j, None])
        one_m = 1.0 - x
        T10, T01 = one_m * q0, one_m * F
        tm, te = _lx_trans(torch.stack([T10 + x, T01, T10, T01 + x],
                                       -1).view(nb, C, 2, 2))
        o, w, jw = _lx_emissions(e[:, j, :, 0], e[:, j, :, 1])
        off = off + o
        rm, re = _lx_step(rm, re, tm, te, w, jw)
    A = torch.log(rm) + re.to(e.dtype) * _LN2 + off[..., None, None]
    return A.view(nb, -1, 2, 2)


def log_block_transfer(e_prob, dist, F, alpha, bs, nb):
    """Each block's 2x2 log-semiring product A [nb, C, 2, 2]: row k is the
    JAX forward recursion over the block's sites started from the unit
    vector e_k (log: 0 at k, -inf elsewhere), formed in linear float64
    with a binary exponent an entry (_log_block_transfer_plain). CUDA
    tensors: float64 kernel; CPU tensors: the plain version."""
    if not e_prob.is_cuda:
        return _log_block_transfer_plain(e_prob, dist, F, alpha, bs, nb)
    S, C = e_prob.shape[0], e_prob.shape[1]
    e_prob, dist, F, alpha = _log_inputs(e_prob, dist, F, alpha)
    A = torch.empty((nb, C, 2, 2), dtype=torch.float64, device=e_prob.device)
    rc = cuda_lib.load().ngsf_log_block_transfer(
        e_prob.data_ptr(), dist.data_ptr(), F.data_ptr(), alpha.data_ptr(),
        A.data_ptr(), S, C, bs, nb, cuda_lib.stream())
    cuda_lib.check(rc, "log_block_transfer")
    LAUNCHES["log_block_transfer"] += 1
    return A


def log_combine_chunk_len(nb):
    """Blocks a chunk of log_combine's two-level walk: about sqrt(nb), and
    enough that the chunks fit one CTA (cuda_lib.LOG_COMBINE_MAX_CHUNKS)."""
    return max(math.isqrt(nb - 1) + 1 if nb > 1 else 1,
               -(-nb // cuda_lib.LOG_COMBINE_MAX_CHUNKS))


def log_combine_launch(nb, C, L):
    """(columns a CTA, threads a CTA, CTAs) of k_log_combine at nb blocks,
    C columns and chunks of L blocks: tn columns x nc chunks x 2
    directions a CTA, tn the largest power of two up to 32 with tn * nc at
    most cuda_lib.LOG_COMBINE_MAX_CHUNKS."""
    nc = -(-nb // L)
    tn = 32
    while tn > 1 and tn * nc > cuda_lib.LOG_COMBINE_MAX_CHUNKS:
        tn //= 2
    return tn, 2 * tn * nc, -(-C // tn)


def _lvm(v0, v1, a):
    """The row vector (v0, v1) times the log 2x2 a [..., 2, 2]."""
    return (logsum2(v0 + a[..., 0, 0], v1 + a[..., 1, 0]),
            logsum2(v0 + a[..., 0, 1], v1 + a[..., 1, 1]))


def _lmv(a, w0, w1):
    """The log 2x2 a [..., 2, 2] times the column vector (w0, w1)."""
    return (logsum2(a[..., 0, 0] + w0, a[..., 0, 1] + w1),
            logsum2(a[..., 1, 0] + w0, a[..., 1, 1] + w1))


def _log_combine_plain(A, F, L=None):
    """Plain version of csrc/log_chain.cu's k_log_combine, in its order:
    the chunk products of L blocks (default log_combine_chunk_len(nb)),
    the walks over the chunks (ll_f, ll_b), the reruns inside every
    chunk, each vectorised over the chunks. The last chunk is padded with
    identity blocks (0 on the diagonal, -inf off it), exact no-ops of
    every step here."""
    PLAIN_CALLS["log_combine"] += 1
    nb, C = A.shape[0], A.shape[1]
    L = log_combine_chunk_len(nb) if L is None else L
    nC = -(-nb // L)
    eye = torch.full((nC * L - nb, C, 2, 2), -torch.inf, dtype=A.dtype,
                     device=A.device)
    eye[..., 0, 0] = eye[..., 1, 1] = 0.0
    Ap = torch.cat([A, eye]).view(nC, L, C, 2, 2)
    # ---- 1. the chunk products
    P = Ap[:, 0]
    for r in range(1, L):
        a = Ap[:, r]
        P = torch.stack([torch.stack(_lvm(P[..., k, 0], P[..., k, 1], a),
                                     -1) for k in range(2)], -2)
    # ---- 2. the walks over the chunks from log q and from 0
    lq = log_q(F)
    V = torch.empty((nC, C, 2), dtype=A.dtype, device=A.device)
    W = torch.empty_like(V)
    v0, v1 = lq[:, 0], lq[:, 1]
    for k in range(nC):
        V[k, :, 0], V[k, :, 1] = v0, v1
        v0, v1 = _lvm(v0, v1, P[k])
    ll_f = logsum2(v0, v1)
    w0 = w1 = torch.zeros_like(v0)
    for k in range(nC - 1, -1, -1):
        W[k, :, 0], W[k, :, 1] = w0, w1
        w0, w1 = _lmv(P[k], w0, w1)
    ll_b = logsum2(w0 + lq[:, 0], w1 + lq[:, 1])
    # ---- 3. every chunk's blocks from its entry and its exit vector
    fw_in = torch.empty((nC, L, C, 2), dtype=A.dtype, device=A.device)
    bw_out = torch.empty_like(fw_in)
    v0, v1 = V[..., 0], V[..., 1]
    w0, w1 = W[..., 0], W[..., 1]
    for r in range(L):
        fw_in[:, r, :, 0], fw_in[:, r, :, 1] = v0, v1
        q = L - 1 - r
        bw_out[:, q, :, 0], bw_out[:, q, :, 1] = w0, w1
        if r < L - 1:
            v0, v1 = _lvm(v0, v1, Ap[:, r])
            w0, w1 = _lmv(Ap[:, q], w0, w1)
    return (fw_in.view(nC * L, C, 2)[:nb], bw_out.view(nC * L, C, 2)[:nb],
            ll_f, ll_b)


def log_combine(A, F):
    """The walks over the block products: (fw_in [nb, C, 2], each block's
    entry vector from log q; bw_out [nb, C, 2], each block's exit vector
    from 0; ll_f [C]; ll_b [C]). Through block 0 the backward walk is the
    JAX backward's sentinel step, so ll_b = logsum(bw_{-1} + log q) as
    there (hmm.py:180-190). In two levels: chunks of
    log_combine_chunk_len(nb) blocks (_log_combine_plain). CUDA tensors:
    float64 kernel; CPU tensors: the plain version."""
    return _log_combine(A, F, log_combine_chunk_len(A.shape[0]))


def _log_combine(A, F, L):
    """log_combine with chunks of L blocks (any L >= 1 whose chunks fit
    one CTA)."""
    if not A.is_cuda:
        return _log_combine_plain(A, F, L)
    nb, C = A.shape[0], A.shape[1]
    cuda_lib.require(A, "log_combine.A", torch.float64, (nb, C, 2, 2))
    F = F.to(torch.float64).contiguous()
    cuda_lib.require(F, "log_combine.F", torch.float64, (C,))
    fw_in = torch.empty((nb, C, 2), dtype=torch.float64, device=A.device)
    bw_out = torch.empty_like(fw_in)
    ll_f = torch.empty((C,), dtype=torch.float64, device=A.device)
    ll_b = torch.empty_like(ll_f)
    tn = log_combine_launch(nb, C, L)[0]
    rc = cuda_lib.load().ngsf_log_combine(
        A.data_ptr(), F.data_ptr(), fw_in.data_ptr(), bw_out.data_ptr(),
        ll_f.data_ptr(), ll_b.data_ptr(), C, nb, L, tn, cuda_lib.stream())
    cuda_lib.check(rc, "log_combine")
    LAUNCHES["log_combine"] += 1
    return fw_in, bw_out, ll_f, ll_b


def _log_sweep_plain(e_prob, dist, F, alpha, fw_in, bw_out, ll_f, bs, grad):
    PLAIN_CALLS["log_sweep"] += 1
    S = e_prob.shape[0]
    nb = fw_in.shape[0]
    e, d = _log_blocks(e_prob, dist, bs, nb)
    v0, v1 = fw_in[..., 0], fw_in[..., 1]
    fw = []
    for j in range(bs):
        v0, v1 = _log_step(v0, v1, _log_trans_elems(F, alpha, d[:, j, None]),
                           e[:, j, :, 0], e[:, j, :, 1])
        fw.append((v0, v1))
    w0, w1 = bw_out[..., 0], bw_out[..., 1]
    L = ll_f[None, :]
    p = torch.empty_like(e[..., 0])  # [nb, bs, C]
    gF = torch.zeros_like(w0)
    ga = torch.zeros_like(w0)
    for j in range(bs - 1, -1, -1):
        x, d_safe, is_break = _decay(alpha, d[:, j, None])  # [nb, C]
        t00, t01, t10, t11 = _log_trans_elems(F, alpha, d[:, j, None])
        e0, e1 = e[:, j, :, 0], e[:, j, :, 1]
        if not grad:
            p[:, j] = torch.exp(fw[j][1] + w1 - L)
        else:
            f0, f1 = fw[j - 1] if j else (fw_in[..., 0], fw_in[..., 1])
            b0, b1 = e0 + w0 - L, e1 + w1 - L
            u00, u01 = torch.exp(f0 + b0), torch.exp(f0 + b1)
            u10, u11 = torch.exp(f1 + b0), torch.exp(f1 + b1)
            one_m = 1.0 - x
            dx = torch.where(is_break, torch.zeros_like(x), d_safe * x)
            gF = gF + one_m * (-u00 + u01 - u10 + u11)
            ga = ga + dx * (F * (u01 - u00) + (1.0 - F) * (u10 - u11))
            if j == 0:  # site 0 (block 0): the initial distribution's term
                eb0, eb1 = torch.exp(b0[0]), torch.exp(b1[0])
                om, x0 = one_m[0], x[0]
                q0 = (om * (1.0 - F) + x0) * eb0 + (om * F) * eb1
                q1 = (om * (1.0 - F)) * eb0 + (om * F + x0) * eb1
                gF[0] = gF[0] + (q1 - q0)
        w0, w1 = (logsum2(t00 + e0 + w0, t01 + e1 + w1),
                  logsum2(t10 + e0 + w0, t11 + e1 + w1))
    if grad:
        return torch.stack([gF, ga], -1)
    return p.view(nb * bs, -1)[:S]


def log_sweep_parks(S, C, grad, free_bytes):
    """Whether log_sweep parks the transitions: its scratch with them,
    float64 [S, 6, C] with grad or [S, 4, C], at most LOG_PARK_SHARE of
    free_bytes."""
    return S * C * 8 * (6 if grad else 4) <= LOG_PARK_SHARE * free_bytes


def log_sweep(e_prob, dist, F, alpha, fw_in, bw_out, ll_f, bs, grad=False,
              park=None):
    """Each block rerun forward from its entry vector and backward from its
    exit vector. grad=False: p_ibd [S, C] = exp(fw1 + bw1 - ll_f) (not
    snapped); grad=True: the Fisher-identity sums of dL/dF and dL/dalpha
    over each block, [nb, C, 2] (block 0 with the initial-distribution
    term; loglik_value_and_grad_sites' docstring). CUDA tensors: float64
    kernel, with grad on a [S, 2, C] scratch of the forward values; park
    (None: log_sweep_parks on cuda_lib.free_bytes) also keeps the
    sites' log transitions there ([S, 6, C], [S, 4, C] without grad),
    which the backward pass reads in place of computing them again, with
    the same bits; CPU tensors: the plain version."""
    if not e_prob.is_cuda:
        return _log_sweep_plain(e_prob, dist, F, alpha, fw_in, bw_out, ll_f,
                                bs, grad)
    S, C = e_prob.shape[0], e_prob.shape[1]
    nb = fw_in.shape[0]
    e_prob, dist, F, alpha = _log_inputs(e_prob, dist, F, alpha)
    for name, t, shape in (("fw_in", fw_in, (nb, C, 2)),
                           ("bw_out", bw_out, (nb, C, 2)),
                           ("ll_f", ll_f, (C,))):
        cuda_lib.require(t, f"log_sweep.{name}", torch.float64, shape)
    dev = e_prob.device
    p = gpart = ws = None
    if park is None:
        park = log_sweep_parks(S, C, grad, cuda_lib.free_bytes(dev))
    planes = (4 if park else 0) + (2 if grad else 0)
    if planes:
        ws = torch.empty((S, planes, C), dtype=torch.float64, device=dev)
    if grad:
        gpart = torch.empty((nb, C, 2), dtype=torch.float64, device=dev)
    else:
        p = torch.empty((S, C), dtype=torch.float64, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = cuda_lib.load().ngsf_log_sweep(
        e_prob.data_ptr(), dist.data_ptr(), F.data_ptr(), alpha.data_ptr(),
        fw_in.data_ptr(), bw_out.data_ptr(), ll_f.data_ptr(), ptr(p),
        ptr(ws), ptr(gpart), S, C, bs, nb, int(grad), int(park),
        cuda_lib.stream())
    cuda_lib.check(rc, "log_sweep")
    LAUNCHES["log_sweep"] += 1
    return gpart if grad else p


def _log_inputs(e_prob, dist, F, alpha):
    """The kernels' float64 inputs, checked (emissions [S, C, 2])."""
    S, C = e_prob.shape[0], e_prob.shape[1]
    cuda_lib.require(e_prob, "log chain e_prob", torch.float64, (S, C, 2))
    dev = e_prob.device
    dist = torch.as_tensor(dist, device=dev).to(torch.float64).contiguous()
    F = F.to(torch.float64).contiguous()
    alpha = alpha.to(torch.float64).contiguous()
    cuda_lib.require(dist, "log chain dist", torch.float64, (S,))
    cuda_lib.require(F, "log chain F", torch.float64, (C,))
    cuda_lib.require(alpha, "log chain alpha", torch.float64, (C,))
    if e_prob.data_ptr() % 16:  # the kernels load a site's pair as double2
        e_prob = e_prob.clone()
    return e_prob, dist, F, alpha


def forward_loglik(F, alpha, e_prob, dist):
    """Forward total log-likelihood [C] (JAX hmm.forward_loglik): the block
    products and the forward walk, no per-site values."""
    S, C = e_prob.shape[0], e_prob.shape[1]
    bs, nb = log_geometry(S, C)
    A = log_block_transfer(e_prob, dist, F, alpha, bs, nb)
    return log_combine(A, F)[2]


def posteriors(e_prob, dist, F, alpha):
    """Forward-backward E-step (JAX hmm.posteriors): (p_ibd [S, C],
    loglik_fw [C], loglik_bw [C]). p_ibd is the state-1 marginal, NOT yet
    snapped by check_interv (callers apply it; EM.cpp:178-185)."""
    S, C = e_prob.shape[0], e_prob.shape[1]
    bs, nb = log_geometry(S, C)
    A = log_block_transfer(e_prob, dist, F, alpha, bs, nb)
    fw_in, bw_out, ll_f, ll_b = log_combine(A, F)
    del A
    p = log_sweep(e_prob, dist, F, alpha, fw_in, bw_out, ll_f, bs)
    return p, ll_f, ll_b


def loglik_value_and_grad(F, alpha, e_prob, dist):
    """Analytic (loglik, dL/dF, dL/dalpha), each [C], by the Fisher
    identity (JAX hmm.loglik_value_and_grad; the terms in
    loglik_value_and_grad_sites' docstring), summed a block at a time by
    log_sweep and then over the blocks."""
    S, C = e_prob.shape[0], e_prob.shape[1]
    bs, nb = log_geometry(S, C)
    A = log_block_transfer(e_prob, dist, F, alpha, bs, nb)
    fw_in, bw_out, ll_f, _ = log_combine(A, F)
    del A
    g = log_sweep(e_prob, dist, F, alpha, fw_in, bw_out, ll_f, bs,
                  grad=True).sum(0)
    return ll_f, g[:, 0], g[:, 1]


# ---------------------------------------------------------------------------
# Viterbi
# ---------------------------------------------------------------------------


# sites per traceback block (csrc/viterbi.cu, _viterbi_plain)
VITERBI_BLOCK = 256
_ID_MAP = 2  # the identity map on {0, 1}, coded f(0) | f(1) << 1


def _compose(m, g):
    """m o g for maps on {0, 1} coded f(0) | f(1) << 1 (uint8 tensors)."""
    return ((m >> (g & 1)) & 1) | (((m >> ((g >> 1) & 1)) & 1) << 1)


def _traceback_blocked(codes, last, L):
    """The Viterbi traceback cut into blocks of L sites.

    codes [S, N] uint8: site s's back-pointers bp0 | bp1 << 1, i.e. the
    map cur -> bp[s][cur]; last [N] uint8: the state at site S - 1. Maps
    compose exactly, so each block's maps fold into one (f_k, the state at
    the site before the block from the state at its last site), a walk
    over the S / L folded maps gives each block's exit state, and every
    block then decodes on its own: path[s] = cur, then cur = bp[s][cur]
    (the step after s = 0 is never used). Pad sites past S are identity
    maps."""
    S, N = codes.shape
    nblk = -(-S // L)
    pad = torch.full((nblk * L - S, N), _ID_MAP, dtype=torch.uint8,
                     device=codes.device)
    codes = torch.cat([codes, pad]).view(nblk, L, N)
    m = torch.full((nblk, N), _ID_MAP, dtype=torch.uint8,
                   device=codes.device)
    for r in range(L):
        m = _compose(m, codes[:, r])
    exits = torch.empty_like(m)
    cur = last
    for k in range(nblk - 1, -1, -1):
        exits[k] = cur
        cur = (m[k] >> cur) & 1
    path = torch.empty((nblk, L, N), dtype=torch.uint8, device=codes.device)
    cur = exits
    for r in range(L - 1, -1, -1):
        path[:, r] = cur
        cur = (codes[:, r] >> cur) & 1
    return path.view(nblk * L, N)[:S].to(torch.int8)


def _viterbi_plain(e_prob, dist, F, alpha, compat, init_logits, final_state,
                   L=VITERBI_BLOCK):
    """Plain version of csrc/viterbi.cu: the per-site forward loop, then
    the blocked traceback (_traceback_blocked) with blocks of L sites."""
    PLAIN_CALLS["viterbi"] += 1
    S, N = e_prob.shape[0], e_prob.shape[1]
    lt00, lt01, lt10, lt11 = _log_trans_elems(F, alpha, dist[:, None])
    if init_logits is None:
        lq = log_q(F)
        v0, v1 = lq[:, 0], lq[:, 1]
    else:
        v0, v1 = init_logits[:, 0], init_logits[:, 1]
    bp0 = torch.empty((S, N), dtype=torch.bool, device=e_prob.device)
    bp1 = torch.empty_like(bp0)
    for s in range(S):
        a0 = v0 + lt00[s]
        b0 = v1 + lt10[s]
        bp0[s] = b0 > a0  # strict >: ties keep k=0
        n0 = torch.maximum(a0, b0) + e_prob[s, :, 0]
        # compat: state-1's k=0 candidate uses the in-place-updated n0
        # (already containing this site's state-0 emission)
        a1 = (n0 if compat else v0) + lt01[s]
        b1 = v1 + lt11[s]
        bp1[s] = b1 > a1
        n1 = torch.maximum(a1, b1) + e_prob[s, :, 1]
        v0, v1 = n0, n1
    if final_state is None:
        cur = v1 > v0  # strict > tie rule
    else:
        cur = final_state.to(torch.bool)
    score = torch.where(cur, v1, v0)
    codes = bp0.to(torch.uint8) | (bp1.to(torch.uint8) << 1)
    return _traceback_blocked(codes, cur.to(torch.uint8), L), score


def viterbi(e_prob, dist, F, alpha, compat=True, init_logits=None,
            final_state=None, L=VITERBI_BLOCK):
    """Most-probable state path: (path [S, N] int8, best score [N]).

    compat=True replicates the reference's production Viterbi
    (HMM.cpp:98-125) including its in-place update: within a site, the
    state-1 maximisation over predecessor k=0 uses the ALREADY-UPDATED
    state-0 score. compat=False is the textbook variant (the unused
    viterbi_NEW, HMM.cpp:62-95). init_logits [N, 2] / final_state [N]
    override the stationary log q init and force the traceback's start.
    L: sites per traceback block (any L >= 1 gives the same path).

    The JAX package runs this as a lax.scan over the sites
    (ngsf_hmm_tpu/models/hmm.py:viterbi). On the card (csrc/viterbi.cu)
    the forward pass stays one serial chain per individual in this order,
    so scores and back-pointers are the plain version's bits; producer
    warps compute its log-transitions a tile of sites ahead into shared
    memory. The traceback folds each block of L sites into one exact map
    and decodes the blocks in parallel. float32 and float64."""
    L = int(L)
    if L < 1:
        raise ValueError(f"viterbi: traceback block length {L} < 1")
    if not e_prob.is_cuda:
        return _viterbi_plain(e_prob, dist, F, alpha, compat, init_logits,
                              final_state, L=L)
    dt = e_prob.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"viterbi: float32 or float64, got {dt}")
    S, N = e_prob.shape[0], e_prob.shape[1]
    dev = e_prob.device
    dist = torch.as_tensor(dist, device=dev).to(dt).contiguous()
    F = F.to(dt).contiguous()
    alpha = alpha.to(dt).contiguous()
    cuda_lib.require(e_prob, "viterbi.e_prob", dt, (S, N, 2))
    cuda_lib.require(dist, "viterbi.dist", dt, (S,))
    cuda_lib.require(F, "viterbi.F", dt, (N,))
    cuda_lib.require(alpha, "viterbi.alpha", dt, (N,))
    il = fs = None
    if init_logits is not None:
        il = init_logits.to(dt).contiguous()
        cuda_lib.require(il, "viterbi.init_logits", dt, (N, 2))
    if final_state is not None:
        fs = final_state.to(torch.int8).contiguous()
        cuda_lib.require(fs, "viterbi.final_state", torch.int8, (N,))
    # scratch: the back-pointer bits of 16 sites a word, and a byte per
    # (individual, traceback block), rows padded to 16 bytes
    bpk = torch.empty((-(-S // 16), N), dtype=torch.int32, device=dev)
    nbp = -(-(-(-S // L)) // 16) * 16
    maps = torch.empty((N, nbp), dtype=torch.uint8, device=dev)
    path = torch.empty((S, N), dtype=torch.int8, device=dev)
    score = torch.empty((N,), dtype=dt, device=dev)
    lib = cuda_lib.load()
    fn = lib.ngsf_viterbi_f32 if dt == torch.float32 else lib.ngsf_viterbi_f64
    rc = fn(e_prob.data_ptr(), dist.data_ptr(), F.data_ptr(),
            alpha.data_ptr(), None if il is None else il.data_ptr(),
            None if fs is None else fs.data_ptr(), bpk.data_ptr(),
            maps.data_ptr(), path.data_ptr(), score.data_ptr(), S, N,
            int(bool(compat)), L, cuda_lib.stream())
    cuda_lib.check(rc, "viterbi")
    LAUNCHES["viterbi"] += 1
    return path, score
