"""Two-state HMM recursions: the scan tier and the per-site oracle.

The scan tier (reference: shared/HMM.cpp:6-125; the JAX package's
models/hmm.py, lax.scans over the sites) is log-space forward / backward /
posteriors / analytic gradient on a blocked chain: ``forward_loglik``,
``posteriors`` and ``loglik_value_and_grad`` run the three kernels of
csrc/log_chain.cu for CUDA tensors (float64 or float32, the emissions'
type; the float32 kernels are counted with "_f32") and their plain
versions, blocked torch loops in the kernels' order, for CPU tensors:

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
# longest block of the float32 tier: its sweep runs a block's chain in
# float32 from vectors taken relative to the log-likelihood, whose values
# grow with the block (about 2 nats a site), and so do their rounding's
# errors: against float64 at 20,000 x 8, p_ibd 1.3e-4 at 128 sites a
# block, 1.1e-3 at 512, 0.12 at 5,000 (the float64 tier's scan_restart
# blocks); more blocks cost only a longer walk in log_combine
LOG_F32_MAX_BS = 128
# the float64 log_sweep parks the sites' log transitions for its backward
# pass (32 bytes of scratch a site and column more than computing them
# again) while its whole scratch takes at most this share of the card's
# free memory; the float32 one computes them again (float32's expf and
# logf cost less than the scratch's traffic: 2.4 ms against 4.6 at 10^6 x
# 100 on an H100, chip_smoke.py)
LOG_PARK_SHARE = 0.5


def log_geometry(S, C, dtype=torch.float64):
    """(bs, nb) of the blocked chain for S sites and C columns: nb blocks of
    bs sites, nb * C lanes at most LOG_LANES_TARGET (but one block at
    least), bs at least LOG_MIN_BS (one block below that), every block
    holding at least one site (the last one the rest); in float32 bs at
    most LOG_F32_MAX_BS (more lanes then)."""
    nb = max(1, min(S // LOG_MIN_BS, LOG_LANES_TARGET // C))
    bs = -(-S // nb)
    if dtype == torch.float32:
        bs = min(bs, LOG_F32_MAX_BS)
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


# log_block_transfer's linear chain (csrc/log_common.cuh, the LX_ constants
# and LxK<T>): each entry is m * 2^E with m in [1, 2) (or 0, with E =
# _LX_EZERO) and an integer E, so nothing flushes while the log-space chain
# stays finite. The exponents are int64 here (int in the kernel: the
# saturation keeps them far inside it), the same for both float types.
_LX_EZERO = -(1 << 29)  # the exponent of a zero entry or transition
_LX_EFLOOR = -(1 << 27)  # a nonzero entry's exponent saturates here
_LX_GAP_MIN = -1048576.0  # (2^20 nats) wider emission gaps count as this
_LN2 = 0.6931471805599453
_LN2_F32 = 0.693147182464599609375  # ln 2 rounded to float32 (exact)


class _LxType:
    """The bit layout and constants of one float type (LxK<T>): drop
    (a product 2^-(drop+1) or less of the other is below the sum's half
    ulp), split (emission gaps below it keep their exponent apart), sub
    (a subnormal transition is scaled by 2^sub), and the Cody-Waite pair
    hi + lo = ln 2."""

    def __init__(self, dtype, itype, mant_bits, bias, drop, split, sub,
                 ln2, inv_ln2, hi, lo):
        self.dtype, self.itype = dtype, itype
        self.shift, self.bias = mant_bits, bias
        self.mant, self.one = (1 << mant_bits) - 1, bias << mant_bits
        self.drop, self.split, self.sub = drop, split, sub
        self.tiny = 2.0 ** (1 - bias)
        self.ln2, self.inv_ln2, self.hi, self.lo = ln2, inv_ln2, hi, lo


_LX = {
    torch.float64: _LxType(
        torch.float64, torch.int64, 52, 1023, 60, -708.0, 54, _LN2,
        1.4426950408889634,
        6.93147180369123816490e-01,  # 32 bits: j * hi is exact
        1.90821492927058770002e-10),
    torch.float32: _LxType(
        torch.float32, torch.int32, 23, 127, 25, -87.0, 24, _LN2_F32,
        1.44269502162933349609375,  # 1 / ln 2 rounded to float32
        _LN2_F32,  # gc - j * hi is formed exactly in float64 (_lx_reduce)
        -1.9046542121259335e-09),  # ln 2 - hi rounded to float32
}


def _lx_norm(v):
    """v (>= 0, normal or 0) as (m in [1, 2) or 0, its binary exponent
    (int64), v == 0): exact bit operations."""
    k = _LX[v.dtype]
    b = v.view(k.itype)
    ex = (b >> k.shift).to(torch.int64)
    zero = ex == 0
    m = ((b & k.mant) | k.one).view(v.dtype)
    return torch.where(zero, torch.zeros_like(m), m), ex - k.bias, zero


def _lx_trans(T):
    """A transition (>= 0, subnormal too) as (m, tau): m in [1, 2) and
    tau its exponent, or (0, _LX_EZERO)."""
    k = _LX[T.dtype]
    sub = (T > 0) & (T < k.tiny)
    m, ex, zero = _lx_norm(torch.where(sub, T * 2.0 ** k.sub, T))
    ex = ex - torch.where(sub, k.sub, 0)
    return m, torch.where(zero, _LX_EZERO, ex)


def _lx_pow2(k, dtype):
    """2^k for integer k <= 0 (exact), 0 below -drop."""
    t = _LX[dtype]
    b = ((k.clamp_min(-t.drop) + t.bias) << t.shift).to(t.itype)
    return torch.where(k < -t.drop, 0.0, b.view(dtype))


def _lx_reduce(gc, j):
    """exp(gc - j ln 2) (log_common.cuh: lx_reduce): float64 with the
    32-bit hi; float32 with gc - j * hi formed in float64, where it is
    exact, as is the kernel's one fused multiply-add (its value a multiple
    of 2^-24 below 1 in magnitude)."""
    k = _LX[gc.dtype]
    if gc.dtype == torch.float64:
        return torch.exp((gc - j * k.hi) - j * k.lo)
    r = (gc.double() - j.double() * k.hi).float()
    return torch.exp(r - j * k.lo)


def _lx_emissions(e0, e1):
    """A site's emissions as (offset, w [..., 2], j [..., 2]): the larger
    one is the offset and its factor 1 (ties: state 0), the other's factor
    w 2^j = exp(e_other - offset), with j = 0 but for gaps below split
    (Cody-Waite: w about (1/2, 1]); both factors 0 and the offset 0 where
    both are -inf."""
    k = _LX[e0.dtype]
    first = e0 >= e1
    hi = torch.where(first, e0, e1)
    lo = torch.where(first, e1, e0)
    dead = hi == -torch.inf
    hs = torch.where(dead, 0.0, hi)
    g = lo - hs
    split = (g < k.split) & (g > -torch.inf)
    gc = g.clamp_min(_LX_GAP_MIN)
    j = torch.trunc(gc * k.inv_ln2)
    w = torch.where(split, _lx_reduce(gc, j), torch.exp(g))
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
    exponent, the other is scaled to it (dropped drop + 1 halvings
    below), the sum times w, renormalised."""
    dt = rm.dtype
    P0 = re[..., :, 0, None] + te[..., None, 0, :]
    P1 = re[..., :, 1, None] + te[..., None, 1, :]
    Pm = torch.maximum(P0, P1)
    s = ((rm[..., :, 0, None] * tm[..., None, 0, :]) * _lx_pow2(P0 - Pm, dt)
         + (rm[..., :, 1, None] * tm[..., None, 1, :]) * _lx_pow2(P1 - Pm, dt))
    m, ex, zero = _lx_norm(s * w[..., None, :])
    E = (Pm + j[..., None, :] + ex).clamp_min(_LX_EFLOOR)
    return m, torch.where(zero, _LX_EZERO, E)


def _log_block_transfer_plain(e_prob, dist, F, alpha, bs, nb):
    """Plain version of csrc/log_chain.cu's k_log_block_transfer, in its
    order: a block's 2x2 product in linear arithmetic of e_prob's float
    type (float64 or float32), each entry carrying
    its own binary exponent, each site's larger log emission summed into
    a lane offset, logs once at the block's end (the four entries of a
    lane as one [nb, C, 2, 2] tensor)."""
    PLAIN_CALLS["log_block_transfer" + _sfx(e_prob.dtype)] += 1
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
    A = (torch.log(rm) + re.to(e.dtype) * _LX[e.dtype].ln2
         + off[..., None, None])
    return A.view(nb, -1, 2, 2)


def log_block_transfer(e_prob, dist, F, alpha, bs, nb):
    """Each block's 2x2 log-semiring product A [nb, C, 2, 2] in e_prob's
    float type (float64 or float32): row k is the JAX forward recursion
    over the block's sites started from the unit vector e_k (log: 0 at k,
    -inf elsewhere), formed in linear arithmetic with a binary exponent an
    entry (_log_block_transfer_plain). CUDA tensors: the kernel of that
    type (counted "log_block_transfer" or "log_block_transfer_f32");
    CPU tensors: the plain version."""
    if not e_prob.is_cuda:
        return _log_block_transfer_plain(e_prob, dist, F, alpha, bs, nb)
    S, C = e_prob.shape[0], e_prob.shape[1]
    e_prob, dist, F, alpha = _log_inputs(e_prob, dist, F, alpha)
    dt = e_prob.dtype
    A = torch.empty((nb, C, 2, 2), dtype=dt, device=e_prob.device)
    name = "log_block_transfer" + _sfx(dt)
    rc = getattr(cuda_lib.load(), "ngsf_" + name)(
        e_prob.data_ptr(), dist.data_ptr(), F.data_ptr(), alpha.data_ptr(),
        A.data_ptr(), S, C, bs, nb, cuda_lib.stream())
    cuda_lib.check(rc, name)
    LAUNCHES[name] += 1
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
    every step here. In float64 whatever A's type (float32 products are
    widened exactly, as the kernel loads them)."""
    PLAIN_CALLS["log_combine" + _sfx(A.dtype)] += 1
    A, F = A.double(), F.double()
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
    log_combine_chunk_len(nb) blocks (_log_combine_plain). Every output
    is float64, for float32 products too (the walks and log-likelihoods
    carried wider: the csrc/log_chain.cu header says why). CUDA tensors:
    the kernel of A's type; CPU tensors: the plain version."""
    return _log_combine(A, F, log_combine_chunk_len(A.shape[0]))


def _log_combine(A, F, L):
    """log_combine with chunks of L blocks (any L >= 1 whose chunks fit
    one CTA)."""
    if not A.is_cuda:
        return _log_combine_plain(A, F, L)
    nb, C = A.shape[0], A.shape[1]
    name = "log_combine" + _sfx(A.dtype)
    cuda_lib.require(A, "log_combine.A", A.dtype, (nb, C, 2, 2))
    if A.data_ptr() % 16:  # the kernels load an entry's four as one vector
        A = A.clone()
    F = F.to(torch.float64).contiguous()
    cuda_lib.require(F, "log_combine.F", torch.float64, (C,))
    fw_in = torch.empty((nb, C, 2), dtype=torch.float64, device=A.device)
    bw_out = torch.empty_like(fw_in)
    ll_f = torch.empty((C,), dtype=torch.float64, device=A.device)
    ll_b = torch.empty_like(ll_f)
    tn = log_combine_launch(nb, C, L)[0]
    rc = getattr(cuda_lib.load(), "ngsf_" + name)(
        A.data_ptr(), F.data_ptr(), fw_in.data_ptr(), bw_out.data_ptr(),
        ll_f.data_ptr(), ll_b.data_ptr(), C, nb, L, tn, cuda_lib.stream())
    cuda_lib.check(rc, name)
    LAUNCHES[name] += 1
    return fw_in, bw_out, ll_f, ll_b


def _sweep_vectors(dtype, fw_in, bw_out, ll_f):
    """The entry and exit vectors and the log-likelihood a sweep of dtype
    runs from, taken from log_combine's float64 ones: float64 as they
    are; float32 relative to ll_f, in float64 (entry fw_in + s - ll_f,
    exit bw_out - s, s the exit's larger entry or 0 where it is
    infinite), then rounded, and 0 for ll_f (k_log_sweep, float32 lanes);
    the fourth item is block 0's s - ll_f [C] rounded, which the
    initial-distribution term adds back to es + bw - ll_f (None in
    float64)."""
    if dtype == torch.float64:
        return fw_in, bw_out, ll_f, None
    x0, x1 = bw_out[..., 0], bw_out[..., 1]
    m = torch.where(x0 >= x1, x0, x1)
    s = torch.where(torch.isinf(m), 0.0, m)
    return (((fw_in + s[..., None]) - ll_f[:, None]).to(dtype),
            (bw_out - s[..., None]).to(dtype),
            torch.zeros_like(ll_f, dtype=dtype), (s[0] - ll_f).to(dtype))


def _log_sweep_plain(e_prob, dist, F, alpha, fw_in, bw_out, ll_f, bs, grad):
    PLAIN_CALLS["log_sweep" + _sfx(e_prob.dtype)] += 1
    S = e_prob.shape[0]
    nb = fw_in.shape[0]
    fw_in, bw_out, ll_f, c0 = _sweep_vectors(e_prob.dtype, fw_in, bw_out,
                                             ll_f)
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
                if c0 is not None:  # float32: back to es + bw - ll_f
                    b0, b1 = b0[0] + c0, b1[0] + c0
                else:
                    b0, b1 = b0[0], b1[0]
                eb0, eb1 = torch.exp(b0), torch.exp(b1)
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
    """Whether the float64 log_sweep parks the transitions: its scratch
    with them, float64 [S, 6, C] with grad or [S, 4, C], at most
    LOG_PARK_SHARE of free_bytes."""
    return S * C * 8 * (6 if grad else 4) <= LOG_PARK_SHARE * free_bytes


def log_sweep(e_prob, dist, F, alpha, fw_in, bw_out, ll_f, bs, grad=False,
              park=None):
    """Each block rerun forward from its entry vector and backward from its
    exit vector. grad=False: p_ibd [S, C] = exp(fw1 + bw1 - ll_f) (not
    snapped); grad=True: the Fisher-identity sums of dL/dF and dL/dalpha
    over each block, [nb, C, 2] (block 0 with the initial-distribution
    term; loglik_value_and_grad_sites' docstring), both in e_prob's float
    type; fw_in, bw_out and ll_f are log_combine's float64 ones (a
    float32 sweep takes them relative to ll_f: _sweep_vectors). CUDA
    tensors: the kernel of that type, with grad on a [S, 2, C] scratch of
    the forward values; park (None: log_sweep_parks on
    cuda_lib.free_bytes in float64, never in float32) also keeps the
    sites' log transitions there ([S, 6, C], [S, 4, C] without grad),
    which the backward pass reads in place of computing them again, with
    the same bits; CPU tensors: the plain version."""
    if not e_prob.is_cuda:
        return _log_sweep_plain(e_prob, dist, F, alpha, fw_in, bw_out, ll_f,
                                bs, grad)
    S, C = e_prob.shape[0], e_prob.shape[1]
    nb = fw_in.shape[0]
    e_prob, dist, F, alpha = _log_inputs(e_prob, dist, F, alpha)
    dt = e_prob.dtype
    for what, t, shape in (("fw_in", fw_in, (nb, C, 2)),
                           ("bw_out", bw_out, (nb, C, 2)),
                           ("ll_f", ll_f, (C,))):
        cuda_lib.require(t, f"log_sweep.{what}", torch.float64, shape)
    dev = e_prob.device
    p = gpart = ws = None
    if park is None:
        park = dt == torch.float64 and log_sweep_parks(
            S, C, grad, cuda_lib.free_bytes(dev))
    planes = (4 if park else 0) + (2 if grad else 0)
    if planes:
        ws = torch.empty((S, planes, C), dtype=dt, device=dev)
    if grad:
        gpart = torch.empty((nb, C, 2), dtype=dt, device=dev)
    else:
        p = torch.empty((S, C), dtype=dt, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    name = "log_sweep" + _sfx(dt)
    rc = getattr(cuda_lib.load(), "ngsf_" + name)(
        e_prob.data_ptr(), dist.data_ptr(), F.data_ptr(), alpha.data_ptr(),
        fw_in.data_ptr(), bw_out.data_ptr(), ll_f.data_ptr(), ptr(p),
        ptr(ws), ptr(gpart), S, C, bs, nb, int(grad), int(park),
        cuda_lib.stream())
    cuda_lib.check(rc, name)
    LAUNCHES[name] += 1
    return gpart if grad else p


def _sfx(dtype):
    """The export and count suffix of the scan tier's kernels of a float
    type: "" for float64, "_f32" for float32; any other type raises."""
    if dtype == torch.float64:
        return ""
    if dtype == torch.float32:
        return "_f32"
    raise TypeError(f"the scan tier runs float64 or float32, got {dtype}")


def _log_inputs(e_prob, dist, F, alpha):
    """The kernels' inputs in e_prob's float type (float64 or float32),
    checked (emissions [S, C, 2])."""
    S, C = e_prob.shape[0], e_prob.shape[1]
    dt = e_prob.dtype
    _sfx(dt)
    cuda_lib.require(e_prob, "log chain e_prob", dt, (S, C, 2))
    dev = e_prob.device
    dist = torch.as_tensor(dist, device=dev).to(dt).contiguous()
    F = F.to(dt).contiguous()
    alpha = alpha.to(dt).contiguous()
    cuda_lib.require(dist, "log chain dist", dt, (S,))
    cuda_lib.require(F, "log chain F", dt, (C,))
    cuda_lib.require(alpha, "log chain alpha", dt, (C,))
    # the kernels load a site's pair as one double2 / float2
    if e_prob.data_ptr() % (2 * e_prob.element_size()):
        e_prob = e_prob.clone()
    return e_prob, dist, F, alpha


def forward_loglik(F, alpha, e_prob, dist):
    """Forward total log-likelihood [C] (JAX hmm.forward_loglik), float64
    on both float types: the block products and the forward walk, no
    per-site values."""
    S, C = e_prob.shape[0], e_prob.shape[1]
    bs, nb = log_geometry(S, C, e_prob.dtype)
    A = log_block_transfer(e_prob, dist, F, alpha, bs, nb)
    return log_combine(A, F)[2]


def posteriors(e_prob, dist, F, alpha):
    """Forward-backward E-step (JAX hmm.posteriors): (p_ibd [S, C] in
    e_prob's float type, loglik_fw [C], loglik_bw [C] in float64). p_ibd
    is the state-1 marginal, NOT yet snapped by check_interv (callers
    apply it; EM.cpp:178-185)."""
    S, C = e_prob.shape[0], e_prob.shape[1]
    bs, nb = log_geometry(S, C, e_prob.dtype)
    A = log_block_transfer(e_prob, dist, F, alpha, bs, nb)
    fw_in, bw_out, ll_f, ll_b = log_combine(A, F)
    del A
    p = log_sweep(e_prob, dist, F, alpha, fw_in, bw_out, ll_f, bs)
    return p, ll_f, ll_b


def loglik_value_and_grad(F, alpha, e_prob, dist):
    """Analytic (loglik, dL/dF, dL/dalpha), each [C], by the Fisher
    identity (JAX hmm.loglik_value_and_grad; the terms in
    loglik_value_and_grad_sites' docstring), summed a block at a time by
    log_sweep and then over the blocks: loglik in float64, the gradient
    in e_prob's float type."""
    S, C = e_prob.shape[0], e_prob.shape[1]
    bs, nb = log_geometry(S, C, e_prob.dtype)
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


# sites a CUDA graph of the plain Viterbi's forward loop holds
VITERBI_GRAPH_SITES = 512


def _viterbi_sites(lt, e_prob, v0, v1, compat, bp0, bp1):
    """The plain Viterbi's forward loop over the sites of lt (the four log
    transitions, each [n, N]) and e_prob [n, N, 2] from the scores (v0,
    v1): writes the back-pointers bp0, bp1 [n, N], returns the scores."""
    lt00, lt01, lt10, lt11 = lt
    for s in range(e_prob.shape[0]):
        a0 = v0 + lt00[s]
        b0 = v1 + lt10[s]
        torch.gt(b0, a0, out=bp0[s])  # strict >: ties keep k=0
        n0 = torch.maximum(a0, b0) + e_prob[s, :, 0]
        # compat: state-1's k=0 candidate uses the in-place-updated n0
        # (already containing this site's state-0 emission)
        a1 = (n0 if compat else v0) + lt01[s]
        b1 = v1 + lt11[s]
        torch.gt(b1, a1, out=bp1[s])
        n1 = torch.maximum(a1, b1) + e_prob[s, :, 1]
        v0, v1 = n0, n1
    return v0, v1


def _viterbi_sites_graphed(lt, e_prob, v0, v1, compat, bp0, bp1,
                           K=VITERBI_GRAPH_SITES):
    """_viterbi_sites on CUDA tensors with its launches replayed: one CUDA
    graph captures the loop over K sites of static buffers; each chunk of
    K sites copies its inputs in, replays the graph and copies its
    back-pointers out (the scores stay in the graph's buffers), and the
    last S % K sites run as they are. The same kernels run in the same
    order on the same values, so the bits are _viterbi_sites'."""
    S = e_prob.shape[0]
    n_chunks = S // K
    if n_chunks < 2:
        return _viterbi_sites(lt, e_prob, v0, v1, compat, bp0, bp1)
    lt_in = [t.new_empty((K,) + t.shape[1:]) for t in lt]
    e_in = e_prob.new_empty((K,) + e_prob.shape[1:])
    bp_out = (bp0.new_empty((K,) + bp0.shape[1:]),
              bp1.new_empty((K,) + bp1.shape[1:]))
    v_in = (v0.clone(), v1.clone())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        w0, w1 = _viterbi_sites(lt_in, e_in, v_in[0], v_in[1], compat,
                                *bp_out)
        v_in[0].copy_(w0)
        v_in[1].copy_(w1)
    for c in range(n_chunks):
        sl = slice(c * K, (c + 1) * K)
        for dst, src in zip(lt_in, lt):
            dst.copy_(src[sl])
        e_in.copy_(e_prob[sl])
        graph.replay()
        bp0[sl].copy_(bp_out[0])
        bp1[sl].copy_(bp_out[1])
    rest = slice(n_chunks * K, S)
    return _viterbi_sites([t[rest] for t in lt], e_prob[rest], v_in[0],
                          v_in[1], compat, bp0[rest], bp1[rest])


def _viterbi_plain(e_prob, dist, F, alpha, compat, init_logits, final_state,
                   L=VITERBI_BLOCK):
    """Plain version of csrc/viterbi.cu: the per-site forward loop
    (_viterbi_sites; on CUDA tensors replayed from a CUDA graph a chunk of
    sites at a time, _viterbi_sites_graphed), then the blocked traceback
    (_traceback_blocked) with blocks of L sites."""
    PLAIN_CALLS["viterbi"] += 1
    S, N = e_prob.shape[0], e_prob.shape[1]
    lt = _log_trans_elems(F, alpha, dist[:, None])
    if init_logits is None:
        lq = log_q(F)
        v0, v1 = lq[:, 0], lq[:, 1]
    else:
        v0, v1 = init_logits[:, 0], init_logits[:, 1]
    bp0 = torch.empty((S, N), dtype=torch.bool, device=e_prob.device)
    bp1 = torch.empty_like(bp0)
    sites = _viterbi_sites_graphed if e_prob.is_cuda else _viterbi_sites
    v0, v1 = sites(lt, e_prob, v0, v1, compat, bp0, bp1)
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
