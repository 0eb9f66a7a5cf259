"""Minor-allele-frequency M-step: the est_maf fixed point, all sites at once.

The reference runs est_maf serially per site (EM.cpp:224-271,
gen_func.cpp:974-1009). Here the fixed point runs for every site at once
as one masked loop; converged sites freeze, so per-site trajectories equal
the serial loops.

Quirk kept: the expected-allele-count accumulators ``num`` / ``den`` are
initialised once outside the fixed point and keep accumulating across its
passes (gen_func.cpp:976-1000), which damps the updates. ``.indF``
frequencies depend on this.

Macro-stepping (``macro=True``): after ``K0`` real passes, each round
evaluates the cross-individual sums and their freq-derivatives once, then
advances the damped recursion through that round's virtual window on the
per-site linearised model -- scalar site math, no [.., N] work. Windows
grow across rounds because the damped ~1/k iterate slows down.

The exact log-space fixed point (``linear=False``, ``macro=False``: the
scan tier's freq M-step, ``--freq e``, the LD path's site 0) runs the
kernel of csrc/maf_log.cu for CUDA tensors (float64, or float32 on the
fused tier; G lanes a site, ``maf_log_geometry``) and the plain
vectorised torch below for CPU tensors. The
other modes are plain torch: the tests' references (on the card too);
inside the fused tier's EM loop the freq M-step runs the kernels of
ops/maf_kernels.py. The plain loop's condition ``any(active)`` is one
device-to-host read a pass.
"""

import torch

from ..utils import cuda_lib
from ..utils.constants import EPSILON, ITER_MAX
from ..utils.cuda_lib import LAUNCHES, PLAIN_CALLS
from .hwe import calc_hwe, miss_data, post_prob

MACRO_K0 = 8  # real full-width passes before linearised macro-stepping
MACRO_MS = (12, 24, 57)  # virtual-window lengths per gradient round


def macro_schedule(n_ind):
    """(K0, M) for ``macro=True``, keyed on the individual count, or None
    (= run exact) below 32 individuals. M is a tuple of virtual-window
    lengths, one gradient-augmented evaluation per entry.

    The linearisation error scales with the squared per-window freq
    movement, which shrinks as the cross-individual sums sharpen (larger
    N) and as the damped iterate slows down (later windows): short early
    windows, long late ones. Below 32 individuals the residual moves too
    much per window for a fixed schedule, and exact passes are cheap."""
    if n_ind < 32:
        return None
    if n_ind < 96:
        return (16, (8, 16, 32, 29))
    return (MACRO_K0, MACRO_MS)


def macro_rounds(K0, M):
    """Normalise a schedule's M spec to the tuple of virtual-window
    lengths covering the reference's ITER_MAX + 1 trip budget. An int M
    expands to repeated windows; values beyond the budget are harmless
    (converged or past-ITER_MAX states advance as masked no-ops)."""
    if isinstance(M, (tuple, list)):
        return tuple(int(m) for m in M)
    n = max(1, -(-(ITER_MAX + 1 - K0) // int(M)))
    return (int(M),) * n


def _advance(st, cn, cd):
    """One damped update + the reference's post-increment exit test.
    st = (freq, num, den, active [bool], passes [int])."""
    freq0, num, den, active, passes = st
    num = torch.where(active, num + cn, num)
    den = torch.where(active, den + cd, den)
    freq = torch.where(active, num / den, freq0)
    passes = passes + 1
    active = active & (torch.abs(freq0 - freq) > EPSILON)
    if passes > ITER_MAX:
        active = torch.zeros_like(active)
    return freq, num, den, active, passes


def est_maf(gl_s, indF, ignore_miss_data=False, axis_name=None, linear=False,
            macro=False):
    """Per-site MAF via the damped EM fixed point.

    gl_s:  [.., N, 3] normalised genotype likelihoods (site-major; any
           leading site shape). LOG space by default; LINEAR space with
           ``linear=True`` (the per-pass math is then transcendental-free).
    indF:  [.., N] per-individual inbreeding weight at each site (the IBD
           posterior during EM; constants at init), or None for a uniform
           prior (gen_func.cpp:987-989).
    macro: emulate the damped trajectory by linearised macro-stepping.
           Requires ``linear=True`` and an explicit ``indF``. True resolves
           (K0, M) via ``macro_schedule(N)`` (exact below 32 individuals);
           a (K0, M) tuple overrides.
    Returns freq [..] (the leading site shape).

    The loop-exit test matches the reference's post-increment condition
    ``while(|prev-freq| > EPS && iters++ < 100)``: the body runs at least
    once and at most ITER_MAX + 1 times.

    Log space without macro on CUDA tensors: maf_log (csrc/maf_log.cu).
    """
    if axis_name is not None:
        raise NotImplementedError(
            "est_maf over a mesh axis (ROADMAP queue 1: 'parallel/')")
    if not linear and not macro:
        if gl_s.is_cuda:
            return maf_log(gl_s, indF, ignore_miss_data)
        PLAIN_CALLS["maf_log"] += 1
    return _est_maf_plain(gl_s, indF, ignore_miss_data, linear, macro)


def _est_maf_plain(gl_s, indF, ignore_miss_data=False, linear=False,
                   macro=False):
    """est_maf's plain version (any device): the masked fixed point over
    every site at once in vectorised torch."""
    lead = gl_s.shape[:-2]
    N = gl_s.shape[-2]
    dtype, dev = gl_s.dtype, gl_s.device

    if ignore_miss_data:
        if linear:
            present = ~(
                (torch.abs(gl_s[..., 0] - gl_s[..., 1]) < EPSILON)
                & (torch.abs(gl_s[..., 1] - gl_s[..., 2]) < EPSILON)
            )
        else:
            present = ~miss_data(gl_s)
        w = present.to(dtype)
    else:
        w = torch.ones(lead + (N,), dtype=dtype, device=dev)

    F = (torch.zeros(lead + (N,), dtype=dtype, device=dev) if indF is None
         else indF)
    two_m_F = 2.0 - F
    # cd identity: the per-individual posteriors are normalised, so the
    # reference's denominator 2*pp1 + (pp0+pp2)*(2-F) == (2-F) + pp1*F
    # exactly (gen_func.cpp:997-999); sum(2-F) does not depend on freq.
    T_w = torch.sum(w * two_m_F, dim=-1)

    def sums(freq):
        """Accumulator contributions (cn, cd - T_w) at ``freq``."""
        if linear:
            raw = gl_s
            if indF is not None:
                raw = gl_s * calc_hwe(freq[..., None], F, log_scale=False)
            pp = raw / raw.sum(-1, keepdim=True)
        elif indF is None:
            pp = torch.exp(post_prob(gl_s, None))
        else:
            pp = torch.exp(post_prob(gl_s, calc_hwe(freq[..., None], F)))
        cn = torch.sum(w * (pp[..., 1] + pp[..., 2] * two_m_F), dim=-1)
        cdv = torch.sum(w * (pp[..., 1] * F), dim=-1)
        return cn, cdv

    def body(st):
        cn, cdv = sums(st[0])
        return _advance(st, cn, T_w + cdv)

    st = (
        torch.full(lead, 0.01, dtype=dtype, device=dev),
        torch.zeros(lead, dtype=dtype, device=dev),
        torch.zeros(lead, dtype=dtype, device=dev),
        torch.ones(lead, dtype=torch.bool, device=dev),
        0,
    )

    sched = None
    if macro:
        if not linear or indF is None:
            raise ValueError("est_maf macro mode requires linear=True and indF")
        sched = macro_schedule(N) if macro is True else macro
    if sched is None:
        while bool(st[3].any()):
            st = body(st)
        return st[0]

    K0, M = sched
    while bool(st[3].any()) and st[4] < K0:
        st = body(st)
    # rounds run unconditionally: a converged (or past-ITER_MAX) state
    # advances as a masked no-op
    for M_r in macro_rounds(K0, M):
        f0 = st[0]
        (cn, cdv), (dcn, dcdv) = torch.func.jvp(
            sums, (f0,), (torch.ones_like(f0),))
        for _ in range(M_r):
            df = st[0] - f0
            st = _advance(st, cn + dcn * df, T_w + cdv + dcdv * df)
    return st[0]


# maf_log's launch (csrc/maf_log.cu): the least share of a warp's lane
# slots that hold an individual; the shared memory a warp may keep its
# sites' cells in (past it the cells are read from device memory every
# pass), and a CTA's target (up to 4 CTAs an SM).
MAF_LOG_FILL = 0.9
MAF_LOG_SMEM_MAX = 96 * 1024
MAF_LOG_SMEM_CTA = 56 * 1024


def maf_log_geometry(N):
    """(G, C) of maf_log for N individuals: a site's segment of G lanes
    (a power of two up to 32, 32 / G sites a warp), each lane holding C =
    ceil(N / G) cells (individuals s, s + G, ...): the widest segment
    whose G C slots are at least MAF_LOG_FILL full (G = 1 always is)."""
    for G in (32, 16, 8, 4, 2, 1):
        C = -(-N // G)
        if N >= MAF_LOG_FILL * G * C:
            return G, C


def maf_log_launch(N, esz):
    """(G, C, warps a CTA, dynamic shared memory a CTA in bytes) of
    maf_log for N individuals of esz-byte floats: a warp's 32 / G sites
    hold their 4 planes of G C cells in shared memory (128 C esz bytes a
    warp); past MAF_LOG_SMEM_MAX, G = 32 and 0 bytes (the cells read from
    device memory every pass)."""
    G, C = maf_log_geometry(N)
    per_warp = 128 * C * esz
    if per_warp > MAF_LOG_SMEM_MAX:
        return 32, -(-N // 32), 8, 0
    warps = max(1, min(8, MAF_LOG_SMEM_CTA // per_warp))
    return G, C, warps, warps * per_warp


def maf_log(gl_s, indF, ignore_miss_data=False):
    """est_maf(gl_s, indF, ignore_miss_data) in log space without macro,
    on the card (csrc/maf_log.cu, G lanes a site: maf_log_launch). gl_s
    [.., N, 3] (made contiguous); indF [.., N] (a [S, N] view whose rows
    are strided, as a replicate's columns of a flattened posterior, is
    read in place), or None for F = 0. float64 or float32, both of one
    dtype. Returns freq [..]."""
    lead, N = gl_s.shape[:-2], gl_s.shape[-2]
    dt, dev = gl_s.dtype, gl_s.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"maf_log: float32 or float64 gl, got {dt}")
    gl2 = gl_s.reshape(-1, N, 3).contiguous()
    S = gl2.shape[0]
    cuda_lib.require(gl2, "maf_log.gl", dt, (S, N, 3))
    F = (torch.zeros((S, N), dtype=dt, device=dev) if indF is None
         else indF.to(dt))
    if F.dim() != 2:
        F = F.reshape(S, N)
    if F.stride(1) != 1:
        F = F.contiguous()
    if not F.is_cuda or tuple(F.shape) != (S, N) or F.dtype != dt:
        raise ValueError(f"maf_log: indF must be a CUDA {dt} [{S}, {N}] "
                         f"tensor, got {F.dtype} {tuple(F.shape)} on "
                         f"{F.device}")
    out = torch.empty((S,), dtype=dt, device=dev)
    G, _, warps, smem = maf_log_launch(N, gl2.element_size())
    lib = cuda_lib.load()
    fn = lib.ngsf_maf_log_f64 if dt == torch.float64 else lib.ngsf_maf_log_f32
    rc = fn(gl2.data_ptr(), F.data_ptr(), out.data_ptr(), S, N, F.stride(0),
            int(bool(ignore_miss_data)), G, warps, smem, cuda_lib.stream())
    cuda_lib.check(rc, "maf_log")
    LAUNCHES["maf_log"] += 1
    return out.reshape(lead)
