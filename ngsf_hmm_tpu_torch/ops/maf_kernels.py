"""The freq M-step on the chain kernels' slabs: est_maf without relayout.

Inside the EM loop the gl slabs (g0, g2; g1 = 1 - g0 - g2) are resident
run constants and the posterior comes out of the fw_post kernel in the
same [bs, nb, N] layout, so the damped fixed point (ops/maf.py) runs
directly on those. Five CUDA kernels (``csrc/maf_*.cu``):

  maf_state_grad  K0 real damped passes, then (cn, cd, dcn, dcd)
  maf_sums_grad   (cn, cd, dcn, dcd) at a given freq
  maf_window      M virtual passes on the linearised per-site model
  maf_exact       the exact fixed point, up to ITER_MAX + 1 passes
  maf_macro       the whole macro schedule in one launch, on [S, N] rows;
                  on the [bs * nb, N] view of the slabs it is the slab
                  kernel of the JAX package's _run_macro_slab (macro_slab,
                  counted as maf_macro_slab)

maf_state_grad, maf_exact and maf_macro give a site a segment of G lanes
and a warp 32 / G sites, each lane C cells with their planes in
registers (state_grad_geometry; exact_geometry for maf_exact, which
serves fewer than 32 individuals and so goes below 8 lanes a site), and
evaluate each cell fused; maf_macro runs its windows once a site, on one
thread of its block. maf_sums_grad gives a site one warp, maf_window a
thread.

The gl slabs may be stored in bfloat16 (models/hmm_kernels.py
prepare_gl_inputs, gl_dtype): maf_state_grad, maf_sums_grad and
maf_macro then run their bfloat16 export ("_bf16", counted under that
name), which upcasts at load; the posterior and all the arithmetic stay
float32. maf_exact reads float32 gl only: the exact route keeps float32
gl for its freq M-step, as the JAX package does (models/em.py).

The emission-slab route of a single run (the LD path) has no gl slabs: its
freq M-step, ``est_maf_rows``, reads the linear gl planes g0 / g2 [S, N]
(run constants) and the snapped posterior [S, N] as rows of N cells, with
maf_macro, or maf_exact on the [S, 1, N] row view below 32 individuals.

Each kernel has a wrapper that launches it for CUDA tensors and takes the
plain PyTorch version beside it only for CPU tensors. The plain versions
are a Python loop over passes of vectorised [bs, nb, N] tensor ops with
the kernels' Horner planes in the kernels' order; the order of the sum
over individuals differs (torch.sum against a strided lane sum and a
shuffle butterfly), and the segment kernels fuse their cell evaluation
into multiply-adds, so the two agree to float32 rounding and, where that
rounding flips the ``|prev - freq| > EPSILON`` test of a site, to one
damped step of that site (about 1e-5).

Per-site state and outputs are [rows, bs, nb], site s = j * bs + r at
[:, r, j]. ``est_maf_slab``, ``est_maf_exact`` and ``est_maf_rows``
return freq [S].
"""

import ctypes

import torch

from ..utils import cuda_lib
from ..utils.constants import EPSILON, ITER_MAX
from ..utils.cuda_lib import LAUNCHES, PLAIN_CALLS
from .maf import macro_rounds, macro_schedule

_f32 = torch.float32
_HET_FLOOR = 1e-15  # linear het floor, calc_HWE F==1 (gen_func.cpp:946-956)


# ---------------------------------------------------------------------------
# shared arithmetic of the plain versions (mirrors csrc/maf_common.cuh)
# ---------------------------------------------------------------------------


def _planes_plain(g0, g2, F):
    """Pass-invariant Horner planes of every cell and T = sum_n (2 - F):
    (dict of [bs, nb, N] tensors, T [bs, nb]). bfloat16 gl is upcast at
    load, as the kernels do."""
    g0, g2 = cuda_lib.upcast(g0), cuda_lib.upcast(g2)
    g1 = 1.0 - g0 - g2
    zero = torch.zeros_like(F)
    two_m_F = 2.0 - F
    het = F == 1.0
    tn1 = torch.where(het, zero, 2.0 - 2.0 * F)
    K = torch.where(het, g1 * _HET_FLOOR, zero)
    h = g1 * tn1
    B = h + (g0 + g2) * F
    P = h + g2 * F * two_m_F
    planes = dict(d0=g0 + K, d1=B - 2.0 * g0, d2=g0 - B + g2,
                  QmP=g2 * two_m_F - P, K=K, P=P, R=h * F, KF=K * F)
    return planes, two_m_F.sum(-1)


def _sums_plain(q, T, freq, grad):
    """(cn, cd) or (cn, cd, dcn, dcd), each [bs, nb], at freq [bs, nb]."""
    f = freq[..., None]
    inv = 1.0 / (q["d0"] + (q["d1"] + q["d2"] * f) * f)
    cni = (q["K"] + (q["P"] + q["QmP"] * f) * f) * inv
    cdi = (q["KF"] + (q["R"] * (1.0 - f)) * f) * inv
    cn, cd = cni.sum(-1), T + cdi.sum(-1)
    if not grad:
        return cn, cd
    dD = q["d1"] + (q["d2"] + q["d2"]) * f
    dcn = ((q["P"] + (q["QmP"] + q["QmP"]) * f - cni * dD) * inv).sum(-1)
    dcd = ((q["R"] * (1.0 - (f + f)) - cdi * dD) * inv).sum(-1)
    return cn, cd, dcn, dcd


def _advance_plain(st, cn, cd, inside):
    """One damped update + the reference's post-increment exit test on
    st = (freq, num, den, active), active as 0/1 float32."""
    freq, num, den, active = st
    prev = freq
    num = num + active * cn
    den = den + active * cd
    freq = freq + active * (num / den - freq)
    moved = (torch.abs(prev - freq) > EPSILON).to(_f32)
    active = active * moved if inside else torch.zeros_like(active)
    return freq, num, den, active


def _init_state(shape, device):
    z = torch.zeros(shape, dtype=_f32, device=device)
    return (torch.full(shape, 0.01, dtype=_f32, device=device), z, z.clone(),
            torch.ones(shape, dtype=_f32, device=device))


def _check_slabs(name, g0, g2, p):
    """Raise unless the slabs fit the kernel; returns (bs, nb, N, the
    export suffix of the gl slabs' dtype)."""
    sfx = cuda_lib.gl_suffix(g0, g2, name)
    bs, nb, N = g0.shape
    for nm, t in (("g0", g0), ("g2", g2), ("p", p)):
        cuda_lib.require(t, f"{name}.{nm}", _f32 if nm == "p" else g0.dtype,
                         (bs, nb, N))
        if t.device != g0.device:
            raise ValueError(f"{name}.{nm}: on {t.device}, slabs on "
                             f"{g0.device}")
    return bs, nb, N, sfx


# ---------------------------------------------------------------------------
# kernel A: maf_state_grad
# ---------------------------------------------------------------------------


def _state_grad_plain(g0, g2, p, K0, tally=None):
    """Plain version of csrc/maf_state_grad.cu -> [8, bs, nb]. tally: a
    list that receives, per pass, the number of sites still active (the
    work this input needs; a converged site's passes are no-ops)."""
    cuda_lib.count_plain("maf_state_grad", g0)
    q, T = _planes_plain(g0, g2, p)
    st = _init_state(g0.shape[:2], g0.device)
    for k in range(K0):
        if tally is not None:
            tally.append(st[3].sum())
        st = _advance_plain(st, *_sums_plain(q, T, st[0], False),
                            k + 1 <= ITER_MAX)
    return torch.stack(st + _sums_plain(q, T, st[0], True))


# most cells a lane of a segment kernel keeps in registers (eight planes
# each)
STATE_GRAD_MAX_CELLS = 8


def _segment_geometry(N, lanes):
    """The fewest lane slots G * C >= N over G in `lanes` with C <=
    STATE_GRAD_MAX_CELLS, the smaller G on a tie (fewer butterfly steps,
    more sites a warp); (32, 0) where no G fits: the cells are read again
    and their planes recomputed at every pass."""
    best = None
    for G in lanes:
        C = -(-int(N) // G)
        if C <= STATE_GRAD_MAX_CELLS and (best is None
                                          or G * C < best[0] * best[1]):
            best = (G, C)
    return best or (32, 0)


def state_grad_geometry(N):
    """(G, C) of kernel A (csrc/maf_state_grad.cu) and of maf_macro
    (csrc/maf_macro.cu) for N individuals: G lanes a site (8, 16 or 32;
    32 / G sites a warp), C cells a lane with their planes in registers.
    The fewest lane slots G * C >= N with C <= STATE_GRAD_MAX_CELLS, the
    smaller G on a tie; above 32 * STATE_GRAD_MAX_CELLS individuals (32,
    0): the cells are read again and their planes recomputed at every
    pass."""
    return _segment_geometry(N, (8, 16, 32))


def exact_geometry(N):
    """(G, C) of maf_exact (csrc/maf_exact.cu) for N individuals: as
    state_grad_geometry, over G of 1, 2, 4, 8, 16 or 32 lanes a site,
    since the exact route serves fewer than 32 individuals (N = 20: G =
    4, C = 5, 8 sites a warp)."""
    return _segment_geometry(N, (1, 2, 4, 8, 16, 32))


def _k_maf_state_grad(g0, g2, p, K0):
    """K0 real damped passes per site, then the sums and their
    freq-derivatives: [8, bs, nb], rows (freq, num, den, active, cn, cd,
    dcn, dcd).

    Replaces the TPU kernel ngsf_hmm_tpu/ops/maf_pallas.py
    :_run_state_grad_slab. Bound by instruction issue (every cell is
    evaluated K0 + 1 times): G lanes a site with C cells each
    (state_grad_geometry), the cells' planes in registers across the
    passes, fused multiply-adds in the cell evaluation."""
    if not g0.is_cuda:
        return _state_grad_plain(g0, g2, p, K0)
    bs, nb, N, sfx = _check_slabs("maf_state_grad", g0, g2, p)
    G, C = state_grad_geometry(N)
    out = torch.empty((8, bs, nb), dtype=_f32, device=g0.device)
    rc = getattr(cuda_lib.load(), "ngsf_maf_state_grad" + sfx)(
        g0.data_ptr(), g2.data_ptr(), p.data_ptr(), out.data_ptr(), bs * nb,
        N, int(K0), G, C, cuda_lib.stream())
    cuda_lib.check(rc, "maf_state_grad" + sfx)
    LAUNCHES["maf_state_grad" + sfx] += 1
    return out


# ---------------------------------------------------------------------------
# kernel B: maf_sums_grad
# ---------------------------------------------------------------------------


def _sums_grad_plain(g0, g2, p, fq):
    """Plain version of csrc/maf_sums_grad.cu -> [4, bs, nb]."""
    cuda_lib.count_plain("maf_sums_grad", g0)
    q, T = _planes_plain(g0, g2, p)
    return torch.stack(_sums_plain(q, T, fq, True))


def _k_maf_sums_grad(g0, g2, p, fq):
    """(cn, cd, dcn, dcd) [4, bs, nb] at the per-site freq fq [bs, nb].

    Replaces the TPU kernel ngsf_hmm_tpu/ops/maf_pallas.py
    :_run_sums_grad_slab. Bound by bytes (three slabs read once)."""
    if not g0.is_cuda:
        return _sums_grad_plain(g0, g2, p, fq)
    bs, nb, N, sfx = _check_slabs("maf_sums_grad", g0, g2, p)
    cuda_lib.require(fq, "maf_sums_grad.fq", _f32, (bs, nb))
    out = torch.empty((4, bs, nb), dtype=_f32, device=g0.device)
    rc = getattr(cuda_lib.load(), "ngsf_maf_sums_grad" + sfx)(
        g0.data_ptr(), g2.data_ptr(), p.data_ptr(), fq.data_ptr(),
        out.data_ptr(), bs * nb, N, cuda_lib.stream())
    cuda_lib.check(rc, "maf_sums_grad" + sfx)
    LAUNCHES["maf_sums_grad" + sfx] += 1
    return out


# ---------------------------------------------------------------------------
# the virtual window
# ---------------------------------------------------------------------------


def _window_steps(st, grads, passes0, M_r, tally=None):
    """M_r virtual passes from st = (freq, num, den, active) on the model
    linearised at st's freq by grads = (cn, cd, dcn, dcd); the arithmetic
    of csrc/maf_window.cu and of maf_macro.cu's windows. Returns the
    advanced st tuple. tally: as in _state_grad_plain."""
    cn0, cd0, dcn, dcd = grads
    st = tuple(st)
    f0 = st[0]
    for k in range(M_r):
        if tally is not None:
            tally.append(st[3].sum())
        df = st[0] - f0
        st = _advance_plain(st, cn0 + dcn * df, cd0 + dcd * df,
                            passes0 + k + 1 <= ITER_MAX)
    return st


def _virtual_window_plain(st, grads, passes0, M_r, tally=None):
    """Plain version of csrc/maf_window.cu: st / grads [4, bs, nb] ->
    [4, bs, nb]. tally: as in _state_grad_plain."""
    PLAIN_CALLS["maf_window"] += 1
    return torch.stack(_window_steps(st, grads, passes0, M_r, tally))


def _k_maf_window(st, grads, passes0, M_r):
    """M_r virtual damped passes on the linearised accumulator model:
    st (freq, num, den, active) and grads (cn, cd, dcn, dcd), each
    [4, bs, nb] -> the advanced st [4, bs, nb]. Step k is inside the
    reference's trip budget while passes0 + k + 1 <= ITER_MAX.

    Stands for ngsf_hmm_tpu/ops/maf_pallas.py:_virtual_window (unrolled
    XLA elementwise math there). Bound by the latency of M_r dependent
    divisions a thread, far above its bytes."""
    if not st.is_cuda:
        return _virtual_window_plain(st, grads, passes0, M_r)
    _, bs, nb = st.shape
    cuda_lib.require(st, "maf_window.st", _f32, (4, bs, nb))
    cuda_lib.require(grads, "maf_window.grads", _f32, (4, bs, nb))
    if grads.device != st.device:
        raise ValueError("maf_window: st and grads on different devices")
    out = torch.empty_like(st)
    rc = cuda_lib.load().ngsf_maf_window(
        st.data_ptr(), grads.data_ptr(), out.data_ptr(), bs * nb,
        int(passes0), int(M_r), cuda_lib.stream())
    cuda_lib.check(rc, "maf_window")
    LAUNCHES["maf_window"] += 1
    return out


# ---------------------------------------------------------------------------
# the exact fixed point
# ---------------------------------------------------------------------------


def _snap(p):
    """check_interv (ops/hwe.py) on the raw posterior slab."""
    p = torch.where(p < EPSILON, torch.zeros_like(p), p)
    return torch.where(p > 1.0 - EPSILON, torch.ones_like(p), p)


def _exact_plain(g0, g2, p, snap, tally=None):
    """Plain version of csrc/maf_exact.cu -> freq [bs, nb]: the Horner
    planes of the snapped (snap=True) or raw posterior, then passes of
    _sums_plain and _advance_plain until no site is active. tally: as in
    _state_grad_plain."""
    PLAIN_CALLS["maf_exact"] += 1
    q, T = _planes_plain(g0, g2, _snap(p) if snap else p)
    st = _init_state(g0.shape[:2], g0.device)
    k = 0
    while bool(st[3].any()):
        if tally is not None:
            tally.append(st[3].sum())
        st = _advance_plain(st, *_sums_plain(q, T, st[0], False),
                            k + 1 <= ITER_MAX)
        k += 1
    return st[0]


def _k_maf_exact(g0, g2, p, snap):
    """The exact damped fixed point per site: freq [bs, nb]. snap=True
    applies check_interv's snap to the posterior as it is read.

    Replaces the TPU kernel ngsf_hmm_tpu/ops/maf_pallas.py:_run. Bound by
    instruction issue (up to ITER_MAX + 1 passes over cells read once): G
    lanes a site with C cells each (exact_geometry), the cells' planes in
    registers, fused cells; a warp stops when all its sites have. Reads
    float32 gl only (the JAX kernel reads float32 tiles)."""
    if g0.dtype != _f32 or g2.dtype != _f32:
        raise TypeError(f"maf_exact reads float32 gl, got {g0.dtype} and "
                        f"{g2.dtype}")
    if not g0.is_cuda:
        return _exact_plain(g0, g2, p, snap)
    bs, nb, N, _ = _check_slabs("maf_exact", g0, g2, p)
    G, C = exact_geometry(N)
    out = torch.empty((bs, nb), dtype=_f32, device=g0.device)
    rc = cuda_lib.load().ngsf_maf_exact(
        g0.data_ptr(), g2.data_ptr(), p.data_ptr(), out.data_ptr(), bs * nb,
        N, int(bool(snap)), G, C, cuda_lib.stream())
    cuda_lib.check(rc, "maf_exact")
    LAUNCHES["maf_exact"] += 1
    return out


# ---------------------------------------------------------------------------
# the whole macro schedule on rows
# ---------------------------------------------------------------------------


def _macro_rows_plain(g0, g2, p, K0, Ms, tally=None, name="maf_macro"):
    """Plain version of csrc/maf_macro.cu: g0 / g2 / p [S, N] -> freq [S].
    K0 real passes, then per round M_r in Ms one gradient evaluation and
    M_r virtual passes (kernel A, then windows and kernel B, on rows).
    tally: a dict that receives, under "pass", "grad" and "step", the
    number of sites still active at each real pass, gradient evaluation
    and virtual pass (the work this input needs). name: the kernel the
    call counts for (maf_macro, or maf_macro_slab on the slab view)."""
    cuda_lib.count_plain(name, g0)
    count = (lambda kind, st: tally[kind].append(st[3].sum())) if (
        tally is not None) else (lambda kind, st: None)
    q, T = _planes_plain(g0, g2, p)
    st = _init_state(g0.shape[:1], g0.device)
    for k in range(K0):
        count("pass", st)
        st = _advance_plain(st, *_sums_plain(q, T, st[0], False),
                            k + 1 <= ITER_MAX)
    passes = K0
    for M_r in Ms:
        count("grad", st)
        st = _window_steps(st, _sums_plain(q, T, st[0], True), passes, M_r,
                           None if tally is None else tally["step"])
        passes += M_r
    return st[0]


def _macro(name, g0, g2, p, K0, Ms):
    """csrc/maf_macro.cu on [rows, N] rows (float32 or bfloat16 g0 / g2,
    float32 p) -> freq [rows], counted under `name` (+ the gl suffix)."""
    if not g0.is_cuda:
        return _macro_rows_plain(g0, g2, p, K0, Ms, name=name)
    S, _, N, sfx = _check_slabs(name, g0[:, None], g2[:, None], p[:, None])
    Ms = tuple(int(m) for m in Ms)
    G, C = state_grad_geometry(N)
    out = torch.empty((S,), dtype=_f32, device=g0.device)
    rc = getattr(cuda_lib.load(), "ngsf_maf_macro" + sfx)(
        g0.data_ptr(), g2.data_ptr(), p.data_ptr(), out.data_ptr(), S, N,
        int(K0), (ctypes.c_int * max(1, len(Ms)))(*Ms), len(Ms), G, C,
        cuda_lib.stream())
    cuda_lib.check(rc, name + sfx)
    LAUNCHES[name + sfx] += 1
    return out


def _k_maf_macro(g0, g2, p, K0, Ms):
    """The macro-stepped est_maf per site on [S, N] rows (g0, g2 linear
    gl planes, p the posterior as read): freq [S]. K0 real passes, then
    for each M_r in Ms (ops/maf.macro_rounds) one gradient evaluation and
    M_r virtual passes, all in one launch.

    Replaces the TPU kernel ngsf_hmm_tpu/ops/maf_pallas.py:_run_macro.
    Bound by operations (the passes and gradient rounds over every cell,
    read once), on the card by their instruction issue and by the
    windows' chain of dependent steps: the passes and gradient rounds in
    kernel A's geometry and fused cells (state_grad_geometry), the cells'
    planes in registers through the schedule; the windows once a site,
    on one thread of the block, with the per-site state in shared memory
    between rounds."""
    return _macro("maf_macro", g0, g2, p, K0, Ms)


def _k_maf_macro_slab(g0, g2, p_slab, K0, Ms):
    """The macro-stepped est_maf per site on the gl slabs g0 / g2
    [bs, nb, N] (float32 or bfloat16) and the raw posterior slab:
    freq [bs, nb], pad sites included (the caller cuts them).

    Replaces the TPU kernel ngsf_hmm_tpu/ops/maf_pallas.py
    :_run_macro_slab. The port's slabs are already rows of N cells (row
    r * nb + j is site j * bs + r), so this is csrc/maf_macro.cu on the
    [bs * nb, N] view of the slabs, its bfloat16 export for bfloat16
    slabs; its plain version is _macro_rows_plain on the same view. It
    counts as maf_macro_slab (maf_macro_slab_bf16). Bound as maf_macro,
    with 8 bytes a cell read under bfloat16 instead of 12."""
    bs, nb, N = g0.shape
    rows = lambda t: t.reshape(bs * nb, N)
    return _macro("maf_macro_slab", rows(g0), rows(g2), rows(p_slab), K0,
                  Ms).reshape(bs, nb)


# ---------------------------------------------------------------------------
# public functions (freq [S], as in the JAX package)
# ---------------------------------------------------------------------------


def _site_vector(x, prep2):
    """[bs, nb] per-site values -> [S]."""
    return x.t().reshape(-1)[:prep2["S"]]


def est_maf_slab(prep2, p_slab, macro=True):
    """Per-site MAF from the gl slabs (float32 or bfloat16) + the RAW
    posterior slab that posteriors_fused(..., return_slab=True) emitted.
    Returns freq [S] float32.

    Kernel A runs the K0 real passes and the first gradient evaluation;
    each round then advances through its virtual window (maf_window), and
    rounds after the first re-evaluate the sums with kernel B at the
    advanced freq. macro: True resolves the schedule with
    macro_schedule(N); a (K0, M) pair overrides. Raises ValueError where
    there is no schedule (N < 32: use est_maf_exact).

    The slab holds UNSNAPPED posteriors: a perturbation of at most EPSILON
    against the snapped state.p_ibd, inside this tier's drift envelope;
    the het floor still engages on the exact 1.0 that fw_post produces
    for certain posteriors. Pad sites (s >= S) are computed on their
    harmless slab values and cut from the result."""
    if macro is True:
        macro = macro_schedule(prep2["N"])
    if not macro:
        raise ValueError("est_maf_slab requires a macro schedule")
    K0, M = macro
    g0, g2 = prep2["g0"], prep2["g2"]
    st8 = _k_maf_state_grad(g0, g2, p_slab, K0)
    st, grads = st8[:4], st8[4:]
    passes = K0
    for r, M_r in enumerate(macro_rounds(K0, M)):
        if r > 0:
            grads = _k_maf_sums_grad(g0, g2, p_slab, st[0])
        st = _k_maf_window(st, grads, passes, M_r)
        passes += M_r
    return _site_vector(st[0], prep2)


def macro_slab(prep2, p_slab, macro=True):
    """Per-site MAF from the gl slabs (float32 or bfloat16) + the RAW
    posterior slab, the whole macro schedule in one launch
    (_k_maf_macro_slab): the counterpart of the JAX package's
    maf_pallas._run_macro_slab followed by est_maf_slab's unpack. Returns
    freq [S] float32; pad sites are cut (the JAX kernel writes the
    sentinel 2.0 there).

    It computes what est_maf_slab computes, with the same arithmetic.
    No EM route calls it, as no JAX route calls _run_macro_slab (its
    split, est_maf_slab, took its place). macro: as in est_maf_slab;
    raises ValueError where there is no schedule (N < 32)."""
    if macro is True:
        macro = macro_schedule(prep2["N"])
    if not macro:
        raise ValueError("macro_slab requires a macro schedule")
    K0, M = macro
    return _site_vector(_k_maf_macro_slab(prep2["g0"], prep2["g2"], p_slab,
                                          K0, macro_rounds(K0, M)), prep2)


def est_maf_exact(prep2, p_slab, snap=True):
    """Per-site MAF by the exact damped fixed point from the gl slabs +
    the raw posterior slab; snap=True reads the posterior through
    check_interv, as the exact tiers of the reference do. Returns freq
    [S] float32. Serves N < 32, where est_maf_slab has no schedule. The
    slabs must be float32 (maf_exact)."""
    return _site_vector(
        _k_maf_exact(prep2["g0"], prep2["g2"], p_slab, snap), prep2)


def gl_rows(gl):
    """[S, N, 3] log GLs -> the linear planes (g0, g2), each [S, N]
    contiguous float32: est_maf_rows' run constants (g1 = 1 - g0 - g2)."""
    return (torch.exp(gl[..., 0]).to(_f32).contiguous(),
            torch.exp(gl[..., 2]).to(_f32).contiguous())


def est_maf_rows(g0, g2, p_ibd, macro=True):
    """Per-site MAF from the linear gl planes g0 / g2 [S, N] (gl_rows) and
    the snapped IBD posterior p_ibd [S, N] (JAX
    maf_pallas.est_maf_pallas(gl_tiles, p_ibd, S, macro)). Returns freq [S]
    float32.

    macro: True resolves the schedule with macro_schedule(N), a (K0, M)
    pair overrides. With a schedule, maf_macro runs it in one launch;
    without one (N < 32, where JAX runs _run), maf_exact runs on the
    [S, 1, N] row view, unsnapped, because p_ibd is already snapped."""
    S, N = g0.shape
    p_ibd = p_ibd.to(_f32).contiguous()
    if macro is True:
        macro = macro_schedule(N)
    if not macro:
        return _k_maf_exact(g0.reshape(S, 1, N), g2.reshape(S, 1, N),
                            p_ibd.reshape(S, 1, N), False).reshape(S)
    K0, M = macro
    return _k_maf_macro(g0, g2, p_ibd, K0, macro_rounds(K0, M))
