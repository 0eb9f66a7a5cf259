"""Input readers: positions -> distances, genotype data -> normalised log GLs.

Pure-NumPy equivalents of the reference readers (reference:
shared/read_data.cpp) including their format quirks:

 - read_pos_dist: CHR+POS text -> inter-site distances in bp; the FIRST
   site's "distance" is its absolute coordinate (read_data.cpp:199-205) and
   chromosome changes produce +inf. Distances < 1 bp are errors.
 - read_geno: three on-disk layouts -- called genotypes {-1,0,1,2} (1 field
   per individual), genotype (log-)likelihood triplets (gzip text), or raw
   binary doubles -- all returned as [S, N, 3] NORMALISED log GLs
   (read_data.cpp:13-116). Text lines keep only numeric tokens and use the
   LAST n_ind*n_geno of them (Beagle marker/allele columns drop out).

These are the pure-Python reference-parity implementations.
"""

import gzip
import os

import numpy as np

from ..utils.constants import BIG, N_GENO


def _open_maybe_gz(path):
    # The reference reads everything through zlib, which transparently
    # handles plain files too (gen_func.cpp:208-223).
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        f.close()
        return gzip.open(path, "rt")
    import io

    return io.TextIOWrapper(f)


def _numeric_tokens(line):
    """Tokens parseable as doubles, in order (split(double), gen_func.cpp:390-417).

    Matches strtod semantics closely enough for genomic inputs: plain
    floats, ints, nan/inf spellings.
    """
    out = []
    for t in line.split():
        try:
            out.append(float(t))
        except ValueError:
            pass
    return out


def read_pos_dist(path, n_sites):
    """Positions file -> (dist_bp [S] float64). dist[0] = first coordinate,
    +inf at chromosome breaks (read_data.cpp:165-218)."""
    dist = np.full(n_sites, np.inf)
    prev_chr = None
    prev_pos = 0
    s = 0
    with _open_maybe_gz(path) as fh:
        for line in fh:
            line = line.rstrip("\r\n")
            if not line or line.startswith("#"):
                continue
            fields = line.split("\t")
            if len(fields) < 2:
                fields = line.split()
            if len(fields) < 2:
                raise ValueError("wrong POS file format!")
            # header detection: second field parses to 0 (read_data.cpp:188)
            try:
                posval = float(fields[1])
            except ValueError:
                posval = 0.0
            if posval == 0.0:
                if s != 0:
                    raise ValueError("header found but not on first line")
                continue
            if s >= n_sites:
                raise ValueError("wrong number of lines in POS file!")
            chrom = fields[0]
            if prev_chr is None:
                prev_chr = chrom
            if chrom == prev_chr:
                dist[s] = posval - prev_pos
                if dist[s] < 1:
                    raise ValueError("invalid distance between adjacent sites!")
            else:
                dist[s] = np.inf
                prev_chr = chrom
            prev_pos = int(posval)
            s += 1
    if s != n_sites:
        raise ValueError("wrong number of lines in POS file!")
    return dist


def _normalise_log(gl):
    """post_prob with no prior: subtract the log-sum (gen_func.cpp:920-932)."""
    m = np.max(gl, axis=-1, keepdims=True)
    norm = np.log(np.sum(np.exp(gl - m), axis=-1, keepdims=True)) + m
    return gl - norm


def read_geno(path, n_ind, n_sites, binary=False, probs=False, log_scale=False):
    """Genotype data -> [S, N, 3] normalised log GLs (float64).

    binary: raw little-endian doubles, site-major [S][N][3] (always
    likelihood triplets; ngsF-HMM.cpp:55-62 forces in_lkl for binary).
    probs: text has 3 fields per individual (GLs or posteriors) instead of
    one called genotype.
    log_scale: text probs already in log space (--loglkl).
    """
    if binary:
        data = np.fromfile(path, dtype="<f8")
        if data.size != n_sites * n_ind * N_GENO:
            raise ValueError("invalid/corrupt genotype input file!")
        gl = data.reshape(n_sites, n_ind, N_GENO)
        if not log_scale:
            with np.errstate(divide="ignore"):
                gl = np.log(gl)
            gl[np.isneginf(gl)] = -BIG
        gl = _normalise_log(gl)
        if np.isnan(gl).any():
            raise ValueError("NaN found! Is the file format correct?")
        return gl

    n_geno = N_GENO if probs else 1
    want = n_ind * n_geno
    gl = np.full((n_sites, n_ind, N_GENO), -BIG)
    s = 0
    with _open_maybe_gz(path) as fh:
        for line in fh:
            line = line.rstrip("\r\n")
            if not line:
                continue
            vals = _numeric_tokens(line)
            if not vals or (s == 0 and len(vals) < want):
                # header (read_data.cpp:63-72)
                if s != 0:
                    raise ValueError("header found but not on first line")
                continue
            if len(vals) < want:
                raise ValueError("wrong GENO file format. Less fields than expected!")
            if s >= n_sites:
                raise ValueError("GENO file not at EOF. Check number of sites!")
            row = np.asarray(vals[len(vals) - want :])
            if probs:
                trip = row.reshape(n_ind, N_GENO)
                if log_scale:
                    gl[s] = trip
                else:
                    with np.errstate(divide="ignore"):
                        gl[s] = np.log(trip)
            else:
                g = row.astype(int)
                if (g > 2).any():
                    raise ValueError(
                        "wrong GENO file format. Genotypes must be coded as {-1,0,1,2}!"
                    )
                missing = g < 0
                gl[s][missing] = np.log(1.0 / N_GENO)
                ok = ~missing
                gl[s][ok, g[ok]] = 0.0  # log(1)
            s += 1
    if s != n_sites:
        raise ValueError("GENO file at premature EOF. Check number of sites!")
    # NOTE: unlike the binary branch, the reference's TEXT branch does NOT
    # map log(0) = -inf to -BIG (no conv_space call, read_data.cpp:83-99);
    # -inf likelihoods flow through normalisation unchanged.
    return _normalise_log(gl)


def read_geno_slab(path, n_ind, n_sites, site_slab, ind_slab,
                   binary=False, probs=False, log_scale=False):
    """Slab read for multi-host loading: only sites
    [site_slab[0], site_slab[0]+site_slab[1]) x individuals
    [ind_slab[0], ind_slab[0]+ind_slab[1]) -> [site_cnt, ind_cnt, 3].

    Each process of a distributed run loads exactly its shard of the GL
    matrix (SURVEY.md §5.8's host-sharded loading; the reference loads
    the full matrix on one host, read_data.cpp:83-99). This pure-Python
    reader reads the whole file and slices (correct, not memory-lean).
    """
    so, sc = map(int, site_slab)
    io_, ic = map(int, ind_slab)
    if so + sc > n_sites or io_ + ic > n_ind:
        raise ValueError("slab out of range")
    full = read_geno(path, n_ind, n_sites, binary=binary, probs=probs,
                     log_scale=log_scale)
    return np.ascontiguousarray(full[so:so + sc, io_:io_ + ic])


def sniff_binary(path, n_ind, n_sites):
    """Suffix + file-size sniff for binary inputs (ngsF-HMM.cpp:47-63)."""
    if path.endswith(".gz"):
        return False
    size = os.stat(path).st_size
    if n_sites != size // 8 // n_ind // N_GENO:
        raise ValueError("invalid/corrupt genotype input file!")
    return True
