"""ngsf_hmm_tpu_torch -- the PyTorch/CUDA port of the inbreeding-tract
(IBD) engine, beside the JAX package it is held against.

A two-state HMM over per-site genotype likelihoods, trained by EM
(forward-backward E-step; M-step for per-individual inbreeding F and
transition rate alpha), decoded with Viterbi, emitting .indF / .ibd /
.geno outputs. This package carries the fused single-device float32
route with the allele frequencies estimated (--freq_est 1, the default)
or held fixed (--freq_est 0); see the README's "PyTorch/CUDA port"
section for what it refuses.

Layout:
  ops/      elementwise math (logsum, HWE, transitions, emissions) and
            est_maf with its kernels' wrappers
  models/   HMM kernels and their plain versions, L-BFGS, the EM engine
  io/       readers/writers with byte parity, GSL RNG parity
  utils/    constants, signals, the CUDA build/loader
  csrc/     the CUDA kernels (built by nvcc at first use into build/)
"""

from .utils.constants import VERSION as __version__
from .cli import main
