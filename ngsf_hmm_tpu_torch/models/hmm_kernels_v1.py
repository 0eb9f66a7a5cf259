"""The HMM chain kernels on precomputed emission slabs ("v1 layout").

Counterpart of the JAX package's first-generation Pallas layer
(ngsf_hmm_tpu/models/hmm_pallas.py:238-955): the chain functions read
LINEAR emission slabs e0 / e1 instead of building the emissions from
(gl, freq). That is the route of flattened replicates (models/restart.py),
whose replicates carry their own allele frequencies: a per-site freq
compact cannot express them, per-cell emissions can.

The four CUDA kernels are those of models/hmm_kernels.py, instantiated for
the emission-slab source (each kernel is a template over its emission
source, csrc/hmm_common.cuh):

  block_transfer_grad_v1  per-block transfer products + (F, alpha) tangents
  block_transfer_v1       per-block transfer products for B candidates
  bw_sites_v1             per-site backward ratio r = bw1 / (bw0 + bw1)
  fw_post_v1              per-site IBD posterior from r

and the cross-block combine is the shared combine_blocks kernel. Each
wrapper launches its kernel for CUDA tensors and takes the plain PyTorch
version beside it only for CPU tensors; the plain versions run the loops
of models/hmm_kernels.py with the emission-slab site function.

The port's own layout: e0 / e1 slabs [bs, nb, L] float32 (L columns: the
individuals, or replicate x individual, column r * N + i), per-site
distance compact dc [bs, nb]; global site s = j * bs + r. Pad sites hold
e = 1 and d = 0, so they are exact no-ops. The layout has no pad lanes
(nb * L threads exactly), so the TPU's pad-lane parameters (F = 0.5,
alpha = 1, hmm_pallas.py:368-377) have no counterpart. The JAX v1 d slab
repeats each site's distance once per column; the compact carries it once
per site (the same function with a third fewer bytes).

Public shapes follow the JAX package: A_r [nb, 5, B, L],
A_g [nb, 13, 1, L], p [S, L], lls [L] (float64, as in hmm_kernels).
"""

import torch

from ..utils import cuda_lib
from ..utils.cuda_lib import LAUNCHES, PLAIN_CALLS
from .hmm_kernels import (_bw_loop, _combine_blocks, _fw_loop, _params,
                          _transfer_grad_loop, _transfer_loop,
                          _unpack_sites2, grad_from_carries, pack_sites2,
                          pick_geom2, site_compact, transfer_candidates)

_f32 = torch.float32


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def emission_slabs(e_lin, bs, nb):
    """[S, L, 2] LINEAR emissions -> (e0, e1) [bs, nb, L] slabs; pad
    sites hold e = 1 (JAX hmm_pallas.emission_slabs)."""
    geom = dict(S=e_lin.shape[0], N=e_lin.shape[1], bs=bs, nb=nb)
    return (pack_sites2(e_lin[..., 0], geom, 1.0),
            pack_sites2(e_lin[..., 1], geom, 1.0))


def make_prep(e0, e1, dc, S, N, bs, nb):
    """prep dict from laid-out slabs + geometry (JAX hmm_pallas.make_prep;
    N is the column count L)."""
    return dict(e0=e0, e1=e1, dc=dc, S=S, N=N, bs=bs, nb=nb)


def prepare_inputs(e_prob_log, dist, bs=None):
    """(e_prob_log [S, L, 2], dist [S]) -> prep dict (JAX
    hmm_pallas.prepare_inputs). Geometry: pick_geom2(S, L) unless bs is
    given."""
    S, L = e_prob_log.shape[0], e_prob_log.shape[1]
    if bs is None:
        bs, nb = pick_geom2(S, L)
    else:
        nb = -(-S // bs)
    e0, e1 = emission_slabs(torch.exp(e_prob_log), bs, nb)
    dc = site_compact(torch.as_tensor(dist, device=e0.device), bs, nb, 0.0)
    return make_prep(e0, e1, dc, S, L, bs, nb)


def _em_site(e0, e1, dc):
    """The v1 emission source of the plain loops: site r, decay rate a ->
    (e0, e1, x, onem), x = exp(-a d) as csrc/hmm_common.cuh EmSource."""
    def site(r, a):
        x = torch.exp(-a * dc[r][:, None])
        return e0[r], e1[r], x, 1.0 - x
    return site


def _check_v1_args(name, e0, e1, dc, F, alpha, B=None):
    bs, nb, L = e0.shape
    dev = e0.device
    for nm, t, shp in (
        ("e0", e0, (bs, nb, L)), ("e1", e1, (bs, nb, L)), ("dc", dc, (bs, nb)),
        ("F", F, (L,) if B is None else (B, L)),
        ("alpha", alpha, (L,) if B is None else (B, L)),
    ):
        cuda_lib.require(t, f"{name}.{nm}", _f32, shp)
        if t.device != dev:
            raise ValueError(f"{name}.{nm}: on {t.device}, slabs on {dev}")
    return bs, nb, L


# ---------------------------------------------------------------------------
# kernel 10: block_transfer_v1
# ---------------------------------------------------------------------------


def _block_transfer_v1_plain(e0, e1, dc, F, alpha):
    """Plain version of csrc/block_transfer.cu's v1 instantiation:
    F/alpha [B, L] -> [5, B, nb, L]."""
    PLAIN_CALLS["block_transfer_v1"] += 1
    return _transfer_loop(_em_site(e0, e1, dc), e0.shape, F, alpha,
                          e0.device)


def _k_block_transfer_v1(e0, e1, dc, F, alpha):
    """Per-block transfer products for B candidates, [5, B, nb, L].

    Replaces the TPU kernel ngsf_hmm_tpu/models/hmm_pallas.py
    :_k_block_transfer. Bound by bytes: the two emission slabs, read once
    per group of candidates; block_transfer's staged stream on the
    emission slabs (csrc/transfer_stream.cuh)."""
    if not e0.is_cuda:
        return _block_transfer_v1_plain(e0, e1, dc, F, alpha)
    B = F.shape[0]
    bs, nb, L = _check_v1_args("block_transfer_v1", e0, e1, dc, F, alpha, B)
    out = torch.empty((5, B, nb, L), dtype=_f32, device=e0.device)
    rc = cuda_lib.load().ngsf_block_transfer_v1(
        e0.data_ptr(), e1.data_ptr(), dc.data_ptr(), F.data_ptr(),
        alpha.data_ptr(), out.data_ptr(), bs, nb, L, B,
        transfer_candidates(B)[0], cuda_lib.stream())
    cuda_lib.check(rc, "block_transfer_v1")
    LAUNCHES["block_transfer_v1"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel 12: block_transfer_grad_v1
# ---------------------------------------------------------------------------


def _block_transfer_grad_v1_plain(e0, e1, dc, F, alpha):
    """Plain version of csrc/block_transfer_grad.cu's v1 instantiation:
    F/alpha [L] -> [13, nb, L]; its primal rows equal
    _block_transfer_v1_plain's output bit for bit."""
    PLAIN_CALLS["block_transfer_grad_v1"] += 1
    return _transfer_grad_loop(_em_site(e0, e1, dc), dc, e0.shape, F, alpha,
                               e0.device)


def _k_block_transfer_grad_v1(e0, e1, dc, F, alpha):
    """Per-block transfer products with (F, alpha) tangents, [13, nb, L].

    Replaces the TPU kernel ngsf_hmm_tpu/models/hmm_pallas.py
    :_k_block_transfer_grad. It runs on every L-BFGS probe. Its bound is
    the two emission slabs' bytes; the kernel is the staged template of
    block_transfer_grad (csrc/block_transfer_grad.cu) on the emission
    slabs."""
    if not e0.is_cuda:
        return _block_transfer_grad_v1_plain(e0, e1, dc, F, alpha)
    bs, nb, L = _check_v1_args("block_transfer_grad_v1", e0, e1, dc, F,
                               alpha)
    out = torch.empty((13, nb, L), dtype=_f32, device=e0.device)
    rc = cuda_lib.load().ngsf_block_transfer_grad_v1(
        e0.data_ptr(), e1.data_ptr(), dc.data_ptr(), F.data_ptr(),
        alpha.data_ptr(), out.data_ptr(), bs, nb, L, cuda_lib.stream())
    cuda_lib.check(rc, "block_transfer_grad_v1")
    LAUNCHES["block_transfer_grad_v1"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel 11: bw_sites_v1
# ---------------------------------------------------------------------------


def _bw_sites_v1_plain(e0, e1, dc, F, alpha, ends):
    """Plain version of csrc/bw_sites.cu's v1 instantiation:
    ends [2, nb, L] -> ratio slab [bs, nb, L]."""
    PLAIN_CALLS["bw_sites_v1"] += 1
    return _bw_loop(_em_site(e0, e1, dc), e0.shape, F, alpha, ends,
                    e0.device)


def _k_bw_sites_v1(e0, e1, dc, F, alpha, ends):
    """Per-site backward ratio slab [bs, nb, L] from each block's end
    vector (ends [2, nb, L]).

    Replaces the TPU kernel ngsf_hmm_tpu/models/hmm_pallas.py:_k_bw_sites,
    which writes bw0 and bw1; the posterior reads them only through the
    ratio, so one slab is written instead of two. Bound by bytes."""
    if not e0.is_cuda:
        return _bw_sites_v1_plain(e0, e1, dc, F, alpha, ends)
    bs, nb, L = _check_v1_args("bw_sites_v1", e0, e1, dc, F, alpha)
    cuda_lib.require(ends, "bw_sites_v1.ends", _f32, (2, nb, L))
    out = torch.empty((bs, nb, L), dtype=_f32, device=e0.device)
    rc = cuda_lib.load().ngsf_bw_sites_v1(
        e0.data_ptr(), e1.data_ptr(), dc.data_ptr(), F.data_ptr(),
        alpha.data_ptr(), ends.data_ptr(), out.data_ptr(), bs, nb, L,
        cuda_lib.stream())
    cuda_lib.check(rc, "bw_sites_v1")
    LAUNCHES["bw_sites_v1"] += 1
    return out


# ---------------------------------------------------------------------------
# kernel 13: fw_post_v1
# ---------------------------------------------------------------------------


def _fw_post_v1_plain(e0, e1, dc, F, alpha, starts, bwr):
    """Plain version of csrc/fw_post.cu's v1 instantiation:
    starts [2, nb, L], ratio slab -> posterior slab [bs, nb, L]."""
    PLAIN_CALLS["fw_post_v1"] += 1
    return _fw_loop(_em_site(e0, e1, dc), e0.shape, F, alpha, starts, bwr,
                    e0.device)


def _k_fw_post_v1(e0, e1, dc, F, alpha, starts, bwr):
    """Per-site IBD posterior slab [bs, nb, L] from each block's start
    vector (starts [2, nb, L]) and the backward ratio slab.

    Replaces the TPU kernel ngsf_hmm_tpu/models/hmm_pallas.py:_k_fw_post.
    Bound by bytes (three slabs read, one written)."""
    if not e0.is_cuda:
        return _fw_post_v1_plain(e0, e1, dc, F, alpha, starts, bwr)
    bs, nb, L = _check_v1_args("fw_post_v1", e0, e1, dc, F, alpha)
    cuda_lib.require(starts, "fw_post_v1.starts", _f32, (2, nb, L))
    cuda_lib.require(bwr, "fw_post_v1.bwr", _f32, (bs, nb, L))
    out = torch.empty((bs, nb, L), dtype=_f32, device=e0.device)
    rc = cuda_lib.load().ngsf_fw_post_v1(
        e0.data_ptr(), e1.data_ptr(), dc.data_ptr(), F.data_ptr(),
        alpha.data_ptr(), starts.data_ptr(), bwr.data_ptr(), out.data_ptr(),
        bs, nb, L, cuda_lib.stream())
    cuda_lib.check(rc, "fw_post_v1")
    LAUNCHES["fw_post_v1"] += 1
    return out


# ---------------------------------------------------------------------------
# public functions (shapes as in the JAX package)
# ---------------------------------------------------------------------------


def block_transfers_v1(F, alpha, prep):
    """Per-block transfer products for [B, L] params: one streamed pass
    over the emission slabs per candidate (JAX
    hmm_pallas.block_transfers_pallas). Returns (A_r [nb, 5, B, L], reps)
    with reps = the float32 (F, alpha) the kernels consume."""
    F, alpha = _params(F, alpha, prep["e0"].device)
    A = _k_block_transfer_v1(prep["e0"], prep["e1"], prep["dc"], F, alpha)
    return A.permute(2, 0, 1, 3), (F, alpha)


def forward_loglik_v1(F, alpha, prep):
    """Per-column loglik [B, L]; F/alpha [B, L] (B = candidates) (JAX
    hmm_pallas.forward_loglik_pallas)."""
    A_r, (F32, _) = block_transfers_v1(F, alpha, prep)
    _, _, lls = _combine_blocks(A_r, F32)
    return lls[0]


def transfer_grad_v1(F, alpha, prep):
    """Fused transfer + tangent stream for [L] params: A_g [nb, 13, 1, L]
    (JAX hmm_pallas.transfer_grad_pallas)."""
    F, alpha = _params(F, alpha, prep["e0"].device)
    out = _k_block_transfer_grad_v1(prep["e0"], prep["e1"], prep["dc"], F,
                                    alpha)
    return out.permute(1, 0, 2).unsqueeze(2)


def loglik_value_and_grad_v1(F, alpha, prep):
    """(ll, dL/dF, dL/dalpha), each [L]; F/alpha [L] (JAX
    hmm_pallas.loglik_value_and_grad_pallas): one transfer + tangent
    stream, then the Fisher-identity assembly of grad_from_carries."""
    return grad_from_carries(transfer_grad_v1(F, alpha, prep), F)


def posteriors_v1(F, alpha, prep, A_reps=None, return_slab=False,
                  return_p=True):
    """(p_ibd [S, L], ll_f [L], ll_b [L]); F/alpha [L] (JAX
    hmm_pallas.posteriors_pallas).

    A_reps: block_transfers_v1 output to reuse (saves the transfer
    stream). return_slab=True appends the RAW [bs, nb, L] posterior slab;
    return_p=False skips the slab -> [S, L] unpack (first element None)."""
    F, alpha = _params(F, alpha, prep["e0"].device)
    if A_reps is None:
        A_reps = block_transfers_v1(F[None], alpha[None], prep)
    A_r, (Fr, ar) = A_reps
    starts, ends, lls = _combine_blocks(A_r, Fr)
    args = (prep["e0"], prep["e1"], prep["dc"], Fr[0].contiguous(),
            ar[0].contiguous())
    bwr = _k_bw_sites_v1(*args, ends[:, :, 0].transpose(0, 1).contiguous())
    p = _k_fw_post_v1(*args, starts[:, :, 0].transpose(0, 1).contiguous(),
                      bwr)
    del bwr
    p_out = _unpack_sites2(p, prep) if return_p else None
    if return_slab:
        return p_out, lls[0, 0], lls[1, 0], p
    return p_out, lls[0, 0], lls[1, 0]
