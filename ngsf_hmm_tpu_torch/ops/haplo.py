"""Two-site haplotype-frequency EM and LD-aware emissions.

Equivalents of the reference's experimental LD path (gen_func.cpp:1027-1178,
shared/HMM.cpp:175-236; enabled by --freq_est 2 / --e_prob 2 and warned as
"under development" at parse_args.cpp:213-214).

Parity note: the reference's log-scale inner iteration
``pair_freq_iter_log`` discards its accumulator update (the ``logsum(tmp,
...)`` result at gen_func.cpp:1160 is never assigned), so every haplotype
frequency it returns is NaN after normalisation. ``haplo_freq(...,
compat=True)`` reproduces that; ``compat=False`` runs the intended
linear-space EM (gen_func.cpp:1076-1119), as the JAX package does
(ngsf_hmm_tpu/ops/haplo.py).

Plain torch: no kernel. All adjacent pairs advance together, and the EM
stops when the LAST pair moves by less than EPSILON (or after ITER_MAX
updates): one global test, as in the JAX package; a pair that has settled
keeps updating while others move. The [pairs, N, 4, 4] pair table is
evaluated in chunks of pairs (``chunk``) to bound memory; chunking changes
no value.
"""

import torch

from ..utils.constants import EPSILON, ITER_MAX
from .emissions import calc_emission

# Haplotype h in {0..3} encodes (site1 allele = h>>1, site2 allele = h&1).
# _G1/_G2: genotype index at site 1 / site 2 of the pair of haplotypes
# (k, h), flattened row-major over (k, h) (gen_func.cpp:1073-1074).
_G1 = tuple((k >> 1 & 1) + (h >> 1 & 1) for k in range(4) for h in range(4))
_G2 = tuple((k & 1) + (h & 1) for k in range(4) for h in range(4))

# elements of one chunk's [pairs, N, 4, 4] table
_CHUNK_CELLS = 1 << 26


def _one_iter(f, p1, p2, g1, g2):
    """One linear-space EM update of haplotype freqs.

    f: [P, 4]; p1/p2: [P, N, 3] linear-space genotype probs; g1/g2: _G1 /
    _G2 as index tensors on their device. Returns the updated f [P, 4]
    (JAX ops/haplo._one_iter, same operation order)."""
    shape = p1.shape[:-1] + (4, 4)
    l1 = p1.index_select(-1, g1).reshape(shape)  # [P, N, 4, 4]
    l2 = p2.index_select(-1, g2).reshape(shape)
    fk = f[:, None, :, None]
    fh = f[:, None, None, :]
    joint = fk * fh * l1 * l2
    del l1, l2
    denom = torch.sum(joint, dim=(-1, -2), keepdim=True)  # [P, N, 1, 1]
    # ff[k] = sum_h f_k f_h (L(h,k) + L(k,h)) / denom == sum over row + col
    contrib = (torch.sum(joint, dim=-1) + torch.sum(joint, dim=-2)) / denom[
        ..., 0]
    ff = torch.sum(contrib, dim=-2)  # over individuals -> [P, 4]
    f_new = ff / (2.0 * p1.shape[-2])
    return f_new / torch.sum(f_new, dim=-1, keepdim=True)


def haplo_freq(pp1, pp2, maf1, maf2, compat=True, chunk=None):
    """ML haplotype frequencies between two adjacent sites.

    pp1/pp2: [..., N, 3] genotype posteriors -- LOG space (as the reference
    passes them). maf1/maf2: [...] (or scalars) current MAF estimates
    (init values). Returns hap_freq [..., 4] = (P_BA, P_Ba, P_bA, P_ba).

    compat=True returns NaN (module docstring). compat=False runs the
    intended EM on exp(pp) until the largest |delta f| over ALL pairs is
    below EPSILON, or ITER_MAX updates. chunk: pairs per evaluation of the
    pair table (default: about 2^26 table cells a chunk)."""
    dt, dev = pp1.dtype, pp1.device
    maf1 = torch.as_tensor(maf1, dtype=dt, device=dev)
    maf2 = torch.as_tensor(maf2, dtype=dt, device=dev)
    init = torch.stack(
        [
            (1 - maf1) * (1 - maf2),
            (1 - maf1) * maf2,
            maf1 * (1 - maf2),
            maf1 * maf2,
        ],
        dim=-1,
    )
    lead, N = pp1.shape[:-2], pp1.shape[-2]
    init = init.expand(lead + (4,))
    if compat:
        return torch.full_like(init, float("nan"))
    P = init[..., 0].numel()
    p1 = pp1.reshape(P, N, 3)
    p2 = pp2.reshape(P, N, 3)
    if chunk is None:
        chunk = max(1, _CHUNK_CELLS // (16 * N))
    g1 = torch.as_tensor(_G1, device=dev)
    g2 = torch.as_tensor(_G2, device=dev)

    def update(f):
        return torch.cat([
            _one_iter(f[c:c + chunk], torch.exp(p1[c:c + chunk]),
                      torch.exp(p2[c:c + chunk]), g1, g2)
            for c in range(0, P, chunk)
        ])

    last = init.reshape(P, 4)
    f = update(last)
    it = 1
    while it < ITER_MAX and bool(
            (torch.amax(torch.abs(f - last), dim=-1) >= EPSILON).any()):
        f, last = update(f), f
        it += 1
    return f.reshape(lead + (4,))


def ld_init_freq(gl):
    """Initial freqs for ``--freq e`` under ``--freq_est 2``.

    The reference (parse_args.cpp:316-321) seeds site 1 with est_maf(F=0)
    and every later site with hap[1]+hap[3] from a pair EM over (s-1, s),
    NaN-broken like every other haplo_freq call (gen_func.cpp:1160). As in
    the JAX package, every pair is seeded with the plain est_maf freqs
    (Jacobi) and runs the intended pair EM on the raw GLs.

    gl: [S, N, 3] log GLs. Returns freq [S]."""
    from .maf import est_maf

    base = est_maf(gl, torch.zeros(gl.shape[:2], dtype=gl.dtype,
                                   device=gl.device))
    hap = haplo_freq(gl[:-1], gl[1:], base[:-1], base[1:], compat=False)
    return torch.cat([base[:1], hap[:, 1] + hap[:, 3]])


def joint_geno_prob(hap_freq, F):
    """P(g_prev, g_curr | hap freqs, shared IBD state F) as a [..., 3, 3]
    table: rows g_prev, cols g_curr (shared/HMM.cpp:211-236; only the
    F_p == F_c case exists in the reference)."""
    h0, h1, h2, h3 = (hap_freq[..., i] for i in range(4))
    z = torch.zeros_like(h0)
    outbred = torch.stack(
        [
            torch.stack([h0 * h0, 2 * h0 * h1, h1 * h1], dim=-1),
            torch.stack([2 * h0 * h2, 2 * (h0 * h3 + h1 * h2), 2 * h1 * h3],
                        dim=-1),
            torch.stack([h2 * h2, 2 * h2 * h3, h3 * h3], dim=-1),
        ],
        dim=-2,
    )
    inbred = torch.stack(
        [
            torch.stack([h0, z, h1], dim=-1),
            torch.stack([z, z, z], dim=-1),
            torch.stack([h2, z, h3], dim=-1),
        ],
        dim=-2,
    )
    F = torch.as_tensor(F, dtype=hap_freq.dtype, device=hap_freq.device)
    return torch.where((F == 0)[..., None, None], outbred, inbred)


def calc_emission_ld(hap_freq, gl_p, gl_c, maf_p, state):
    """LD-conditioned log emission (shared/HMM.cpp:175-207, live branch).

    hap_freq: [..., 4]; gl_p/gl_c: [..., 3] log GLs (prev/curr site);
    maf_p: [...]; state: 0/1. Returns log P(g_c | g_p) under the pair model:
    log sum_{g_p,g_c} P(g_p,g_c) s_p[g_p] s_c[g_c]  -  e(gl_p, maf_p, state).
    """
    s_p = torch.exp(gl_p)
    s_c = torch.exp(gl_c)
    maf_p = torch.as_tensor(maf_p, dtype=gl_p.dtype, device=gl_p.device)
    jp = joint_geno_prob(hap_freq, torch.full(maf_p.shape, float(state),
                                              dtype=gl_p.dtype,
                                              device=gl_p.device))
    total = torch.sum(jp * s_p[..., :, None] * s_c[..., None, :],
                      dim=(-1, -2))
    e_prev = calc_emission(gl_p, maf_p)[..., state]
    return torch.log(total) - e_prev


def ld_emissions(hap, gl, freq, chunk=None):
    """LD emissions of sites 1..S-1, [S-1, N, 2] log: calc_emission_ld for
    both states, with each pair's haplotype freqs hap [S-1, 4], the
    previous site's GLs and freq (gl [S, N, 3] log, freq [S]) -- the
    construction of JAX init_state / em_iteration (em.py:130-141,
    :606-614), evaluated in chunks of sites (default: about 2^26 cells of
    the [sites, N, 3, 3] table a chunk; chunking changes no value)."""
    S, N = gl.shape[0], gl.shape[1]
    if chunk is None:
        chunk = max(1, _CHUNK_CELLS // (9 * N))
    out = torch.empty((S - 1, N, 2), dtype=gl.dtype, device=gl.device)
    for c in range(0, S - 1, chunk):
        e = min(c + chunk, S - 1)
        for k in (0, 1):
            out[c:e, :, k] = calc_emission_ld(
                hap[c:e, None, :], gl[c:e], gl[c + 1:e + 1],
                freq[c:e, None], k)
    return out
