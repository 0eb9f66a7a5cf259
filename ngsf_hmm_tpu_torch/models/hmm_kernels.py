"""The HMM chain kernels ("gl layout") and the functions built on them.

The chain of S sites is cut into nb blocks of bs sites. Four CUDA kernels
(``csrc/*.cu``) stream the genotype likelihoods once each, one thread per
(block, individual) lane with the 2x2 carry in registers, and compute the
emissions in-kernel from (gl, freq):

  block_transfer_grad  per-block transfer products + (F, alpha) tangents
  block_transfer       per-block transfer products for B candidates
  bw_sites             per-site backward ratio r = bw1 / (bw0 + bw1)
  fw_post              per-site IBD posterior from r

A fifth small kernel (``combine_blocks``) chains the per-block products
across blocks. Each kernel has a wrapper that launches it for CUDA
tensors and takes the plain PyTorch version beside it only for CPU
tensors; the plain versions are a Python loop over the bs within-block
sites of vectorised [nb, N] tensor ops, in the kernel's op order.

The port's own layout (see ``csrc/hmm_common.cuh``): gl0 / gl2 slabs
[bs, nb, N], per-site freq / dist compacts [bs, nb], global site
s = j * bs + r. Pad sites carry freq = 2.0 (sentinel: emission exactly 1)
and dist = 0 (identity transition), so they are exact no-ops.

Public shapes follow the JAX package (models/hmm_pallas.py): transfer
products [nb, K, B, N], posteriors [S, N], log-likelihoods [N]. The
log-likelihoods are float64: the combine sums the block offsets in
double, so |ll_f - ll_b| measures the chain arithmetic and not the
rounding of a float32 sum.
"""

import math

import torch

from ..utils import cuda_lib
from ..utils.cuda_lib import LAUNCHES, PLAIN_CALLS

_TINY = 1e-30
_LN2 = math.log(2.0)
_HET_FLOOR = 1e-15  # linear het floor, calc_HWE F==1 (gen_func.cpp:946-956)

# Lanes (nb * N threads) the geometry aims for: enough resident threads to
# fill the 132 SMs of an H100 at 2048 threads each.
LANES_TARGET = 132 * 2048
MIN_BS = 32  # shortest within-block chain worth a lane

_f32 = torch.float32


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def pick_geom2(S, N):
    """(bs, nb) for S sites and N individuals: about LANES_TARGET lanes,
    blocks no shorter than MIN_BS sites."""
    S = max(int(S), 1)
    nb_t = max(1, -(-LANES_TARGET // max(int(N), 1)))
    nb_t = max(1, min(nb_t, S // MIN_BS))
    bs = -(-S // nb_t)
    return bs, -(-S // bs)


def site_compact(vec, bs, nb, pad_value):
    """[S] per-site vector -> [bs, nb] compact (float32)."""
    S = vec.shape[0]
    x = vec.to(_f32)
    x = torch.nn.functional.pad(x, (0, nb * bs - S), value=pad_value)
    return x.reshape(nb, bs).t().contiguous()


def pack_sites2(x, prep2, pad_value=0.0):
    """[S, N] -> [bs, nb, N] slab (inverse of _unpack_sites2)."""
    S, N, bs, nb = prep2["S"], prep2["N"], prep2["bs"], prep2["nb"]
    x = torch.nn.functional.pad(x.to(_f32), (0, 0, 0, nb * bs - S),
                                value=pad_value)
    return x.reshape(nb, bs, N).transpose(0, 1).contiguous()


def _unpack_sites2(p, prep2):
    """[bs, nb, N] per-site kernel output -> [S, N]."""
    S, N, bs, nb = prep2["S"], prep2["N"], prep2["bs"], prep2["nb"]
    return p.transpose(0, 1).reshape(nb * bs, N)[:S]


def gl_slabs(gl_lin, bs, nb):
    """[S, N, 3] LINEAR gls -> (gl0, gl2) [bs, nb, N] slabs. Built once
    per run (gl is constant across EM iterations); pad cells get 1/3."""
    geom = dict(S=gl_lin.shape[0], N=gl_lin.shape[1], bs=bs, nb=nb)
    return (pack_sites2(gl_lin[..., 0], geom, 1.0 / 3.0),
            pack_sites2(gl_lin[..., 2], geom, 1.0 / 3.0))


def make_prep2(g0, g2, dc, S, N, bs, nb):
    """prep2 dict from laid-out slabs + geometry."""
    return dict(g0=g0, g2=g2, dc=dc, S=S, N=N, bs=bs, nb=nb)


def prepare_gl_inputs(gl_lin, dist, bs=None):
    """(gl_lin [S, N, 3] LINEAR, dist [S]) -> prep2 dict. Run-constant:
    build once, thread everywhere. freq enters per iteration via
    freq_compact."""
    S, N = gl_lin.shape[0], gl_lin.shape[1]
    if bs is None:
        bs, nb = pick_geom2(S, N)
    else:
        nb = -(-S // bs)
    g0, g2 = gl_slabs(gl_lin, bs, nb)
    dc = site_compact(torch.as_tensor(dist, device=gl_lin.device), bs, nb, 0.0)
    return make_prep2(g0, g2, dc, S, N, bs, nb)


def freq_compact(freq, prep2):
    """Per-iteration freq -> compact; the pad sentinel 2.0 forces pad
    emissions to exactly 1 (identity together with d = 0)."""
    return site_compact(freq, prep2["bs"], prep2["nb"], 2.0)


# ---------------------------------------------------------------------------
# shared arithmetic of the plain versions (mirrors csrc/hmm_common.cuh)
# ---------------------------------------------------------------------------


def _pow2_rescale(mx):
    """(scale, exponent): scale = 2^-e, e = floor(log2(mx)), both from
    mx's float32 exponent field. Multiplying by scale is exact."""
    exb = mx.view(torch.int32) >> 23
    scale = ((254 - exb) << 23).view(_f32)
    return scale, exb - 127


def _site_plain(g0r, g2r, fr, dr, a):
    """Emissions and decay of one within-block site: g0r/g2r [nb, N],
    fr/dr [nb], a [..., 1, N] -> (e0, e1 [nb, N], x, onem [..., nb, N])."""
    f = fr[:, None]
    pad = f > 1.0
    zero = torch.zeros_like(f)
    one_m = 1.0 - f
    pq = one_m * f
    i0 = torch.where(pad, torch.ones_like(f), zero)
    pr0 = torch.where(pad, zero, one_m * one_m)
    pq2 = torch.where(pad, zero, 2.0 * pq)
    pr2 = torch.where(pad, zero, f * f)
    s10 = torch.where(pad, zero, one_m * one_m + pq)
    het = torch.where(pad, zero, torch.full_like(f, _HET_FLOOR))
    s12 = torch.where(pad, zero, f * f + pq)
    g1r = 1.0 - g0r - g2r
    e0 = i0 + g0r * pr0 + g1r * pq2 + g2r * pr2
    e1 = i0 + g0r * s10 + g1r * het + g2r * s12
    x = torch.exp(-a * dr[:, None])
    return e0, e1, x, 1.0 - x


def _site_matrix_plain(e0, e1, x, onem, F):
    t00 = onem * (1.0 - F) + x
    t01 = onem * F
    t10 = onem * (1.0 - F)
    t11 = onem * F + x
    return t00 * e0, t01 * e1, t10 * e0, t11 * e1


def _max4(a, b, c, d):
    return torch.maximum(torch.maximum(a, b), torch.maximum(c, d))


def _mm4(a, b):
    a00, a01, a10, a11 = a
    b00, b01, b10, b11 = b
    return (a00 * b00 + a01 * b10, a00 * b01 + a01 * b11,
            a10 * b00 + a11 * b10, a10 * b01 + a11 * b11)


def _tiny(x):
    return torch.clamp_min(x, _TINY)


def _check_stream_args(name, g0, g2, fc, dc, F, alpha, B=None):
    bs, nb, N = g0.shape
    dev = g0.device
    for nm, t, shp in (
        ("g0", g0, (bs, nb, N)), ("g2", g2, (bs, nb, N)),
        ("fc", fc, (bs, nb)), ("dc", dc, (bs, nb)),
        ("F", F, (N,) if B is None else (B, N)),
        ("alpha", alpha, (N,) if B is None else (B, N)),
    ):
        cuda_lib.require(t, f"{name}.{nm}", _f32, shp)
        if t.device != dev:
            raise ValueError(f"{name}.{nm}: on {t.device}, slabs on {dev}")
    return bs, nb, N


# ---------------------------------------------------------------------------
# kernel 4: block_transfer
# ---------------------------------------------------------------------------


def _block_transfer_plain(g0, g2, fc, dc, F, alpha):
    """Plain version of csrc/block_transfer.cu: F/alpha [B, N] ->
    [5, B, nb, N]."""
    PLAIN_CALLS["block_transfer"] += 1
    bs, nb, N = g0.shape
    B = F.shape[0]
    Fb, ab = F[:, None, :], alpha[:, None, :]
    one = torch.ones((B, nb, N), dtype=_f32, device=g0.device)
    c = (one, torch.zeros_like(one), torch.zeros_like(one), one.clone())
    ex = torch.zeros((B, nb, N), dtype=torch.int32, device=g0.device)
    for r in range(bs):
        e0, e1, x, onem = _site_plain(g0[r], g2[r], fc[r], dc[r], ab)
        m = _site_matrix_plain(e0, e1, x, onem, Fb)
        n = _mm4(c, m)
        sc, e = _pow2_rescale(_tiny(_max4(*n)))
        c = tuple(v * sc for v in n)
        ex = ex + e
    return torch.stack(c + (ex.to(_f32) * _LN2,))


def _k_block_transfer(g0, g2, fc, dc, F, alpha):
    """Per-block transfer products for B candidates, [5, B, nb, N].

    Replaces the TPU kernel ngsf_hmm_tpu/models/hmm_pallas.py
    :_k2_block_transfer. On the card it is bound by bytes (the two gl
    slabs, read once per candidate); the design keeps every carry in
    registers and reads the slabs with neighbouring threads on
    neighbouring addresses."""
    if not g0.is_cuda:
        return _block_transfer_plain(g0, g2, fc, dc, F, alpha)
    B = F.shape[0]
    bs, nb, N = _check_stream_args("block_transfer", g0, g2, fc, dc, F,
                                   alpha, B=B)
    out = torch.empty((5, B, nb, N), dtype=_f32, device=g0.device)
    rc = cuda_lib.load().ngsf_block_transfer(
        g0.data_ptr(), g2.data_ptr(), fc.data_ptr(), dc.data_ptr(),
        F.data_ptr(), alpha.data_ptr(), out.data_ptr(), bs, nb, N, B,
        cuda_lib.stream())
    cuda_lib.check(rc, "block_transfer")
    LAUNCHES["block_transfer"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel 1: block_transfer_grad
# ---------------------------------------------------------------------------


def _block_transfer_grad_plain(g0, g2, fc, dc, F, alpha):
    """Plain version of csrc/block_transfer_grad.cu: F/alpha [N] ->
    [13, nb, N]. The primal rows go through the same functions as
    _block_transfer_plain, so they equal its output bit for bit."""
    PLAIN_CALLS["block_transfer_grad"] += 1
    bs, nb, N = g0.shape
    Fb, ab = F[None, :], alpha[None, :]
    one = torch.ones((nb, N), dtype=_f32, device=g0.device)
    zero = torch.zeros_like(one)
    c = (one, zero, zero, one.clone())
    cF = (zero,) * 4
    ca = (zero,) * 4
    ex = torch.zeros((nb, N), dtype=torch.int32, device=g0.device)
    for r in range(bs):
        e0, e1, x, onem = _site_plain(g0[r], g2[r], fc[r], dc[r], ab)
        m = _site_matrix_plain(e0, e1, x, onem, Fb)
        # d x forced to 0 at a chromosome break (d = inf, x = 0)
        dxp = torch.where(x > 0.0, dc[r][:, None] * x, torch.zeros_like(x))
        oe0, oe1 = onem * e0, onem * e1
        fd, gd = Fb * dxp, (1.0 - Fb) * dxp
        mF = (-oe0, oe1, -oe0, oe1)
        ma = (-fd * e0, fd * e1, gd * e0, -gd * e1)
        n = _mm4(c, m)
        nF = tuple(p + q for p, q in zip(_mm4(cF, m), _mm4(c, mF)))
        na = tuple(p + q for p, q in zip(_mm4(ca, m), _mm4(c, ma)))
        sc, e = _pow2_rescale(_tiny(_max4(*n)))
        c = tuple(v * sc for v in n)
        cF = tuple(v * sc for v in nF)
        ca = tuple(v * sc for v in na)
        ex = ex + e
    return torch.stack(c + cF + ca + (ex.to(_f32) * _LN2,))


def _k_block_transfer_grad(g0, g2, fc, dc, F, alpha):
    """Per-block transfer products with (F, alpha) tangents, [13, nb, N]:
    primal (4), d/dF (4), d/dalpha (4), log-offset (1).

    Replaces the TPU kernel ngsf_hmm_tpu/models/hmm_pallas.py
    :_k2_block_transfer_grad. It runs in the E-step and on every L-BFGS
    probe. By bytes its bound is the two gl slabs; with about 110 float
    operations a cell and no FMA contraction (bit identity with
    block_transfer) it is close to the float32 rate too. The 12 carries
    and the exponent sum stay in registers."""
    if not g0.is_cuda:
        return _block_transfer_grad_plain(g0, g2, fc, dc, F, alpha)
    bs, nb, N = _check_stream_args("block_transfer_grad", g0, g2, fc, dc, F,
                                   alpha)
    out = torch.empty((13, nb, N), dtype=_f32, device=g0.device)
    rc = cuda_lib.load().ngsf_block_transfer_grad(
        g0.data_ptr(), g2.data_ptr(), fc.data_ptr(), dc.data_ptr(),
        F.data_ptr(), alpha.data_ptr(), out.data_ptr(), bs, nb, N,
        cuda_lib.stream())
    cuda_lib.check(rc, "block_transfer_grad")
    LAUNCHES["block_transfer_grad"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel 2: bw_sites
# ---------------------------------------------------------------------------


def _bw_sites_plain(g0, g2, fc, dc, F, alpha, ends):
    """Plain version of csrc/bw_sites.cu: ends [2, nb, N] -> ratio slab
    [bs, nb, N]."""
    PLAIN_CALLS["bw_sites"] += 1
    bs = g0.shape[0]
    Fb, ab = F[None, :], alpha[None, :]
    w0, w1 = ends[0], ends[1]
    out = torch.empty_like(g0)
    for r in range(bs - 1, -1, -1):
        out[r] = w1 / _tiny(w0 + w1)
        e0, e1, x, onem = _site_plain(g0[r], g2[r], fc[r], dc[r], ab)
        m00, m01, m10, m11 = _site_matrix_plain(e0, e1, x, onem, Fb)
        b0 = m00 * w0 + m01 * w1
        b1 = m10 * w0 + m11 * w1
        sc, _ = _pow2_rescale(_tiny(torch.maximum(b0, b1)))
        w0, w1 = b0 * sc, b1 * sc
    return out


def _k_bw_sites(g0, g2, fc, dc, F, alpha, ends):
    """Per-site backward ratio slab [bs, nb, N] from each block's end
    vector (ends [2, nb, N]).

    Replaces the TPU kernel ngsf_hmm_tpu/models/hmm_pallas.py
    :_k2_bw_sites. Bound by bytes (two slabs read, one written); each
    lane walks its block's sites in reverse with a 2-vector carry."""
    if not g0.is_cuda:
        return _bw_sites_plain(g0, g2, fc, dc, F, alpha, ends)
    bs, nb, N = _check_stream_args("bw_sites", g0, g2, fc, dc, F, alpha)
    cuda_lib.require(ends, "bw_sites.ends", _f32, (2, nb, N))
    out = torch.empty((bs, nb, N), dtype=_f32, device=g0.device)
    rc = cuda_lib.load().ngsf_bw_sites(
        g0.data_ptr(), g2.data_ptr(), fc.data_ptr(), dc.data_ptr(),
        F.data_ptr(), alpha.data_ptr(), ends.data_ptr(), out.data_ptr(),
        bs, nb, N, cuda_lib.stream())
    cuda_lib.check(rc, "bw_sites")
    LAUNCHES["bw_sites"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel 3: fw_post
# ---------------------------------------------------------------------------


def _fw_post_plain(g0, g2, fc, dc, F, alpha, starts, bwr):
    """Plain version of csrc/fw_post.cu: starts [2, nb, N], ratio slab ->
    posterior slab [bs, nb, N]."""
    PLAIN_CALLS["fw_post"] += 1
    bs = g0.shape[0]
    Fb, ab = F[None, :], alpha[None, :]
    v0, v1 = starts[0], starts[1]
    out = torch.empty_like(g0)
    for r in range(bs):
        e0, e1, x, onem = _site_plain(g0[r], g2[r], fc[r], dc[r], ab)
        m00, m01, m10, m11 = _site_matrix_plain(e0, e1, x, onem, Fb)
        n0 = v0 * m00 + v1 * m10
        n1 = v0 * m01 + v1 * m11
        sc, _ = _pow2_rescale(_tiny(torch.maximum(n0, n1)))
        v0, v1 = n0 * sc, n1 * sc
        x0 = v0 * (1.0 - bwr[r])
        x1 = v1 * bwr[r]
        out[r] = x1 / _tiny(x0 + x1)
    return out


def _k_fw_post(g0, g2, fc, dc, F, alpha, starts, bwr):
    """Per-site IBD posterior slab [bs, nb, N] from each block's start
    vector (starts [2, nb, N]) and the backward ratio slab.

    Replaces the TPU kernel ngsf_hmm_tpu/models/hmm_pallas.py
    :_k2_fw_post. Bound by bytes (three slabs read, one written)."""
    if not g0.is_cuda:
        return _fw_post_plain(g0, g2, fc, dc, F, alpha, starts, bwr)
    bs, nb, N = _check_stream_args("fw_post", g0, g2, fc, dc, F, alpha)
    cuda_lib.require(starts, "fw_post.starts", _f32, (2, nb, N))
    cuda_lib.require(bwr, "fw_post.bwr", _f32, (bs, nb, N))
    out = torch.empty((bs, nb, N), dtype=_f32, device=g0.device)
    rc = cuda_lib.load().ngsf_fw_post(
        g0.data_ptr(), g2.data_ptr(), fc.data_ptr(), dc.data_ptr(),
        F.data_ptr(), alpha.data_ptr(), starts.data_ptr(), bwr.data_ptr(),
        out.data_ptr(), bs, nb, N, cuda_lib.stream())
    cuda_lib.check(rc, "fw_post")
    LAUNCHES["fw_post"] += 1
    return out


# ---------------------------------------------------------------------------
# cross-block combine
# ---------------------------------------------------------------------------


def _combine_blocks_plain(A_r, F):
    """Plain version of csrc/combine_blocks.cu (a loop over the blocks)."""
    PLAIN_CALLS["combine_blocks"] += 1
    nb, _, B, N = A_r.shape
    f64 = torch.float64
    q1 = F.to(_f32)
    q0 = 1.0 - q1
    starts = torch.empty((nb, 2, B, N), dtype=_f32, device=A_r.device)
    ends = torch.empty_like(starts)

    v0, v1 = q0, q1
    ex = torch.zeros((B, N), dtype=torch.int64, device=A_r.device)
    off = torch.zeros((B, N), dtype=f64, device=A_r.device)
    for j in range(nb):
        starts[j, 0], starts[j, 1] = v0, v1
        a = A_r[j]
        n0 = v0 * a[0] + v1 * a[2]
        n1 = v0 * a[1] + v1 * a[3]
        off = off + a[4].to(f64)
        sc, e = _pow2_rescale(_tiny(torch.maximum(n0, n1)))
        v0, v1 = n0 * sc, n1 * sc
        ex = ex + e
    ll_f = torch.log(v0.to(f64) + v1.to(f64)) + off + ex.to(f64) * _LN2

    w0 = torch.ones((B, N), dtype=_f32, device=A_r.device)
    w1 = w0.clone()
    ex = torch.zeros_like(ex)
    off = torch.zeros_like(off)
    for j in range(nb - 1, -1, -1):
        ends[j, 0], ends[j, 1] = w0, w1
        a = A_r[j]
        b0 = a[0] * w0 + a[1] * w1
        b1 = a[2] * w0 + a[3] * w1
        off = off + a[4].to(f64)
        sc, e = _pow2_rescale(_tiny(torch.maximum(b0, b1)))
        w0, w1 = b0 * sc, b1 * sc
        ex = ex + e
    ll_b = (torch.log(q0.to(f64) * w0.to(f64) + q1.to(f64) * w1.to(f64))
            + off + ex.to(f64) * _LN2)
    return starts, ends, torch.stack([ll_f, ll_b])


def _combine_blocks(A_r, F, v0=None, wT=None):
    """Cross-block pass over the per-block transfer products.

    A_r [nb, 5, B, N] (4 product entries + log-offset, any strides with
    unit stride over N); F [B, N]. Returns (starts [nb, 2, B, N]: forward
    vector entering each block, ends [nb, 2, B, N]: backward vector at
    each block's last site, lls [2, B, N] float64 = (ll_f, ll_b)).

    The JAX package runs this as two XLA associative scans
    (ngsf_hmm_tpu/models/hmm_pallas.py:_combine_blocks); here it is one
    small CUDA kernel, one thread per (B, N) chain. It is bound by the
    latency of that chain, not by bytes.

    v0 / wT (boundary carries of a site shard) wait for site sharding."""
    if v0 is not None or wT is not None:
        raise NotImplementedError(
            "boundary carries v0/wT (ROADMAP queue 1: 'Streaming', 'parallel/')")
    nb, K, B, N = A_r.shape
    if K != 5:
        raise ValueError(f"combine_blocks: A_r has {K} rows, expected 5")
    if not A_r.is_cuda:
        return _combine_blocks_plain(A_r, F)
    if A_r.dtype != _f32 or A_r.stride(3) != 1:
        raise ValueError("combine_blocks: A_r must be float32 with unit "
                         "stride over individuals")
    F = F.to(_f32).contiguous()
    cuda_lib.require(F, "combine_blocks.F", _f32, (B, N))
    if F.device != A_r.device:
        raise ValueError("combine_blocks: F and A_r on different devices")
    starts = torch.empty((nb, 2, B, N), dtype=_f32, device=A_r.device)
    ends = torch.empty_like(starts)
    lls = torch.empty((2, B, N), dtype=torch.float64, device=A_r.device)
    rc = cuda_lib.load().ngsf_combine_blocks(
        A_r.data_ptr(), A_r.stride(0), A_r.stride(1), A_r.stride(2),
        F.data_ptr(), starts.data_ptr(), ends.data_ptr(), lls.data_ptr(),
        nb, B, N, cuda_lib.stream())
    cuda_lib.check(rc, "combine_blocks")
    LAUNCHES["combine_blocks"] += 1
    return starts, ends, lls


# ---------------------------------------------------------------------------
# public functions (shapes as in the JAX package)
# ---------------------------------------------------------------------------


def _params(F, alpha, device):
    return (torch.as_tensor(F, device=device).to(_f32).contiguous(),
            torch.as_tensor(alpha, device=device).to(_f32).contiguous())


def block_transfers_fused(F, alpha, prep2, fc):
    """Per-block transfer products for [B, N] params: one streamed pass
    over the gl slabs per candidate. Returns (A_r [nb, 5, B, N], reps)
    with reps = the float32 (F, alpha) the kernels consume."""
    F, alpha = _params(F, alpha, prep2["g0"].device)
    A = _k_block_transfer(prep2["g0"], prep2["g2"], fc, prep2["dc"], F, alpha)
    return A.permute(2, 0, 1, 3), (F, alpha)


def transfer_grad_fused(F, alpha, prep2, fc):
    """Fused transfer + tangent stream for [N] params:
    A_g [nb, 13, 1, N]."""
    F, alpha = _params(F, alpha, prep2["g0"].device)
    out = _k_block_transfer_grad(prep2["g0"], prep2["g2"], fc, prep2["dc"],
                                 F, alpha)
    return out.permute(1, 0, 2).unsqueeze(2)


def forward_loglik_fused(F, alpha, prep2, fc):
    """Per-individual loglik [B, N]; F/alpha [B, N] (B = candidates)."""
    A_r, (F32, _) = block_transfers_fused(F, alpha, prep2, fc)
    _, _, lls = _combine_blocks(A_r, F32)
    return lls[0]


def transfer_grad_reps_fused(F, alpha, prep2, fc):
    """ONE fused transfer + tangent stream serving BOTH the E-step and the
    M-step's first evaluation.

    Returns (A_g [nb, 13, 1, N], A_reps) where A_reps = (primal rows of
    A_g, params) is exactly block_transfers_fused's B = 1 output, bit for
    bit: both kernels take their primal from the same device functions
    and are compiled without FMA contraction. posteriors_fused(A_reps=...)
    then reproduces the separate transfer pass while
    grad_from_carries(A_g, F) gives the M-step's first (value, gradient)
    with no extra stream."""
    F, alpha = _params(F, alpha, prep2["g0"].device)
    A_g = transfer_grad_fused(F, alpha, prep2, fc)
    A_r = torch.cat([A_g[:, 0:4], A_g[:, 12:13]], dim=1)
    return A_g, (A_r, (F[None], alpha[None]))


def grad_from_carries(A_g, F):
    """Fisher-identity (ll, dL/dF, dL/dalpha), each [N], from the fused
    stream's block tangents:

      dll/dtheta = sum_j [v_j . dM_j . w_j] / [v_j . M_j . w_j]

    plus the initial-distribution dq/dF term on block 0. Every scale
    cancels in the ratios."""
    F2 = torch.as_tensor(F, device=A_g.device).to(_f32)[None, :]
    A_prim = torch.cat([A_g[:, 0:4], A_g[:, 12:13]], dim=1)
    starts, ends, lls = _combine_blocks(A_prim, F2)

    v0_, v1_ = starts[:, 0, 0], starts[:, 1, 0]  # [nb, N] entering block j
    w0_, w1_ = ends[:, 0, 0], ends[:, 1, 0]  # [nb, N] at block j's end
    T = A_g[:, 0:4, 0]  # [nb, 4, N]
    DF = A_g[:, 4:8, 0]
    Da = A_g[:, 8:12, 0]

    def quad(M):
        return v0_ * (M[:, 0] * w0_ + M[:, 1] * w1_) + v1_ * (
            M[:, 2] * w0_ + M[:, 3] * w1_
        )

    inv = 1.0 / _tiny(quad(T))
    gF = (quad(DF) * inv).sum(0)
    ga = (quad(Da) * inv).sum(0)

    X0 = T[0, 0] * w0_[0] + T[0, 1] * w1_[0]
    X1 = T[0, 2] * w0_[0] + T[0, 3] * w1_[0]
    q1 = F2[0]
    tot = (1.0 - q1) * X0 + q1 * X1
    gF = gF + (X1 - X0) / _tiny(tot)
    return lls[0, 0], gF, ga


def loglik_value_and_grad_fused(F, alpha, prep2, fc):
    """(ll, dL/dF, dL/dalpha), each [N]; F/alpha [N]."""
    A_g = transfer_grad_fused(F, alpha, prep2, fc)
    return grad_from_carries(A_g, F)


def posteriors_fused(F, alpha, prep2, fc, v0=None, wT=None, A_reps=None,
                     return_slab=False, return_p=True):
    """(p_ibd [S, N], ll_f [N], ll_b [N]); F/alpha [N].

    A_reps: block_transfers_fused / transfer_grad_reps_fused output to
    reuse (saves the transfer stream). return_slab=True appends the RAW
    [bs, nb, N] posterior slab (pre-unpack). return_p=False skips the
    slab -> [S, N] unpack (first element is then None)."""
    if v0 is not None or wT is not None:
        raise NotImplementedError(
            "boundary carries v0/wT (ROADMAP queue 1: 'Streaming', 'parallel/')")
    F, alpha = _params(F, alpha, prep2["g0"].device)
    if A_reps is None:
        A_reps = block_transfers_fused(F[None], alpha[None], prep2, fc)
    A_r, (Fr, ar) = A_reps
    starts, ends, lls = _combine_blocks(A_r, Fr)
    args = (prep2["g0"], prep2["g2"], fc, prep2["dc"], Fr[0].contiguous(),
            ar[0].contiguous())
    bwr = _k_bw_sites(*args, ends[:, :, 0].transpose(0, 1).contiguous())
    p = _k_fw_post(*args, starts[:, :, 0].transpose(0, 1).contiguous(), bwr)
    p_out = _unpack_sites2(p, prep2) if return_p else None
    if return_slab:
        return p_out, lls[0, 0], lls[1, 0], p
    return p_out, lls[0, 0], lls[1, 0]
