"""Output writers with byte parity to the reference.

The reference opens its outputs with zlib mode "wT" -- TRANSPARENT write
(no gzip wrapper, no compression; EM.cpp:296,325,361) -- so .indF/.ibd are
plain text and .geno is raw little-endian doubles despite the gz handles.

Formats (reference: print_iter, EM.cpp:293-380):
 .indF : "%.10f\n" total lkl; per individual "%.5f\t%f\n" (F snapped to
         0/1 with alpha printed as "NA" when within EPSILON of the bounds,
         EM.cpp:306-313); per site "%f\n" freq.
 .ibd  : "//\t" + per-individual lkls joined with "\t" at "%.10f"; one
         ASCII 0/1 row per individual (Viterbi path); one "%f"-formatted
         tab-joined row per individual (IBD posteriors).
 .geno : per site x individual: 3 posteriors (exp space) as binary doubles,
         with the HWE prior conditioned on the VITERBI state (EM.cpp:372).
"""

import numpy as np

from ..utils.constants import EPSILON, N_GENO
from .readers import _normalise_log


def fmt_f(x):
    """C "%f" (six decimals)."""
    return f"{x:.6f}"


def write_indF(path, tot_lkl, indF, alpha, freq):
    with open(path, "w") as fh:
        fh.write(f"{tot_lkl:.10f}\n")
        for F, a in zip(indF, alpha):
            if F < EPSILON:
                fh.write(f"{0.0:.5f}\tNA\n")
            elif F > 1 - EPSILON:
                fh.write(f"{1.0:.5f}\tNA\n")
            else:
                fh.write(f"{F:.5f}\t{a:.6f}\n")
        # np.char.mod uses C printf ("%f"): byte-identical to the
        # reference's gzprintf and vectorised for multi-M-site outputs
        fh.write("\n".join(np.char.mod("%f", np.asarray(freq))))
        if len(freq):
            fh.write("\n")


def write_ibd_header(fh, ind_lkl):
    """The "//\\t"-prefixed per-ind lkl line (EM.cpp:331-336); ONE
    definition shared by every .ibd writer (incl. the multi-host
    part-file stitcher in cli.py)."""
    fh.write("//\t" + "\t".join(f"{v:.10f}" for v in ind_lkl) + "\n")


def write_ibd(path, ind_lkl, path_states, p_ibd):
    """path_states: [S, N] ints; p_ibd: [S, N] floats (marg_prob[..,1])."""
    S, N = path_states.shape
    with open(path, "w") as fh:
        write_ibd_header(fh, ind_lkl)
        digits = (path_states.astype(np.uint8) + ord("0")).astype(np.uint8)
        for i in range(N):
            fh.write(digits[:, i].tobytes().decode("ascii") + "\n")
        post_txt = np.char.mod("%f", np.asarray(p_ibd))  # C printf, fast
        for i in range(N):
            fh.write("\t".join(post_txt[:, i]) + "\n")


def write_path_rows(fh, blocks):
    """ASCII 0/1 Viterbi rows, one per individual, from [S, B] blocks."""
    for blk in blocks:
        digits = (blk.astype(np.uint8) + ord("0")).astype(np.uint8)
        for i in range(blk.shape[1]):
            fh.write(digits[:, i].tobytes().decode("ascii") + "\n")


def write_post_rows(fh, blocks):
    """"%f"-formatted tab-joined posterior rows from [S, B] blocks."""
    for blk in blocks:
        post_txt = np.char.mod("%f", np.asarray(blk))
        for i in range(blk.shape[1]):
            fh.write("\t".join(post_txt[:, i]) + "\n")


def write_ibd_streamed(path, ind_lkl, path_blocks, pibd_blocks):
    """Chunked .ibd writer: byte-identical to write_ibd without ever
    holding the [S, N] path/posterior matrices whole on the host.

    path_blocks / pibd_blocks yield [S, B] blocks of B individuals in
    ind order (the file is per-IND rows, so blocks are fetched along the
    ind axis; each block only needs its own columns resident). The two
    iterators are consumed sequentially -- all path rows precede all
    posterior rows in the format (EM.cpp:322-356)."""
    with open(path, "w") as fh:
        write_ibd_header(fh, ind_lkl)
        write_path_rows(fh, path_blocks)
        write_post_rows(fh, pibd_blocks)


def geno_posteriors(gl, freq, path_states, exact_libm=False):
    """[S, N, 3] exp-space genotype posteriors with the Viterbi-
    conditioned HWE prior (EM.cpp:369-376; prior F = path state).

    exact_libm: glibc-exact transcendentals for --opt compat runs; not
    ported yet (raises NotImplementedError)."""
    F = path_states.astype(np.float64)
    p = freq[:, None]
    pq = (1 - p) * p
    g0 = (1 - p) ** 2 + pq * F
    g1 = 2 * pq - 2 * pq * F
    g2 = p**2 + pq * F
    prior = np.stack([g0, g1, g2], axis=-1)
    if exact_libm:
        raise NotImplementedError(
            "exact_libm .geno bytes belong to --opt compat "
            "(ROADMAP queue 1: '--opt compat')"
        )
    with np.errstate(divide="ignore"):
        lpri = np.log(prior)
    lpri[np.isneginf(lpri)] = -1e15
    lpri[..., 1] = np.where(F == 1.0, -1e15, lpri[..., 1])
    return np.exp(_normalise_log(gl + lpri))


def write_geno(path, gl, freq, path_states, exact_libm=False):
    """Genotype posteriors as binary doubles, site-major (EM.cpp:358-379).

    gl: [S, N, 3] normalised log GLs; freq: [S]; path_states: [S, N].
    """
    S, N = path_states.shape
    pp = geno_posteriors(gl, freq, path_states, exact_libm=exact_libm)
    pp.astype("<f8").reshape(S, N * N_GENO).tofile(path)


def write_geno_streamed(path, chunk_iter):
    """Chunked .geno writer: chunk_iter yields (gl_c, freq_c, path_c)
    in site order; identical bytes to write_geno on the concatenation."""
    with open(path, "wb") as fh:
        for gl_c, freq_c, path_c in chunk_iter:
            pp = geno_posteriors(gl_c, freq_c, path_c)
            S_c, N = path_c.shape
            fh.write(pp.astype("<f8").reshape(S_c, N * N_GENO).tobytes())
