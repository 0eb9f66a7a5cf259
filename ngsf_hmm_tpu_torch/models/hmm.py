"""Two-state HMM recursions as per-site loops over all individuals.

The sequential tier (reference: shared/HMM.cpp:6-125): log-space
forward / backward / posteriors / analytic gradient as plain Python loops
over the sites, each step a vectorised op over the N individuals. They
are the test oracles inside the port (float64 or float32, small shapes
only); the speed path is models/hmm_kernels.py. ``viterbi`` is on the
main path and runs as a CUDA kernel for CUDA tensors.

Conventions (0-based):
 - e_prob: [S, N, 2]   log emissions, site-major
 - dist:   [S]         distance (Mb) from the previous site; dist[0] is
                       the first site's absolute coordinate
                       (read_data.cpp:199-205 quirk) and chromosome breaks
                       are +inf
 - F, alpha: [N]
 - fw/bw:  [S, N, 2]   log forward/backward values
"""

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


def forward_loglik(F, alpha, e_prob, dist):
    """Forward total log-likelihood [N] only."""
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


def posteriors(e_prob, dist, F, alpha):
    """Forward-backward E-step: (p_ibd [S, N], loglik_fw [N],
    loglik_bw [N]). p_ibd is the state-1 marginal, NOT yet snapped by
    check_interv (callers apply it; EM.cpp:178-185)."""
    fw, ll_f = forward(e_prob, dist, F, alpha)
    bw, ll_b = backward(e_prob, dist, F, alpha)
    p_ibd = torch.exp(fw[:, :, 1] + bw[:, :, 1] - ll_f[None, :])
    return p_ibd, ll_f, ll_b


def loglik_value_and_grad(F, alpha, e_prob, dist):
    """Analytic (loglik, dL/dF, dL/dalpha), each [N], via forward-backward
    and the Fisher identity

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
# Viterbi
# ---------------------------------------------------------------------------


def _viterbi_plain(e_prob, dist, F, alpha, compat, init_logits, final_state):
    """Plain version of csrc/viterbi.cu: the per-site loop."""
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
    path = torch.empty((S, N), dtype=torch.int8, device=e_prob.device)
    for s in range(S - 1, -1, -1):
        path[s] = cur
        if s > 0:
            cur = torch.where(cur, bp1[s], bp0[s])
    return path, score


def viterbi(e_prob, dist, F, alpha, compat=True, init_logits=None,
            final_state=None):
    """Most-probable state path: (path [S, N] int8, best score [N]).

    compat=True replicates the reference's production Viterbi
    (HMM.cpp:98-125) including its in-place update: within a site, the
    state-1 maximisation over predecessor k=0 uses the ALREADY-UPDATED
    state-0 score. compat=False is the textbook variant (the unused
    viterbi_NEW, HMM.cpp:62-95). init_logits [N, 2] / final_state [N]
    override the stationary log q init and force the traceback's start.

    The JAX package runs this as a lax.scan over the sites
    (ngsf_hmm_tpu/models/hmm.py:viterbi); on the card it is one CUDA
    kernel (csrc/viterbi.cu): eight lanes per individual compute the
    log-transitions of eight sites side by side and then walk them in
    order, forward pass and traceback alike. It is bound by the latency
    of the S-step chain. float32 and float64."""
    if not e_prob.is_cuda:
        return _viterbi_plain(e_prob, dist, F, alpha, compat, init_logits,
                              final_state)
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
    bp = torch.empty((S, N), dtype=torch.uint8, device=dev)
    path = torch.empty((S, N), dtype=torch.int8, device=dev)
    score = torch.empty((N,), dtype=dt, device=dev)
    lib = cuda_lib.load()
    fn = lib.ngsf_viterbi_f32 if dt == torch.float32 else lib.ngsf_viterbi_f64
    rc = fn(e_prob.data_ptr(), dist.data_ptr(), F.data_ptr(),
            alpha.data_ptr(), None if il is None else il.data_ptr(),
            None if fs is None else fs.data_ptr(), bp.data_ptr(),
            path.data_ptr(), score.data_ptr(), S, N, int(bool(compat)),
            cuda_lib.stream())
    cuda_lib.check(rc, "viterbi")
    LAUNCHES["viterbi"] += 1
    return path, score
