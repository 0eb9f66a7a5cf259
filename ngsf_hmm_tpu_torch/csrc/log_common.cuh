// Float64 log-space helpers shared by the scan tier's kernels
// (log_chain.cu, maf_log.cu), each in the operation order of its plain
// PyTorch version and of the JAX package's float64 tier, so that the
// kernels and their plain versions differ only by the rounding of the
// libraries' exp and log:
//   * logsum2 / logsum3: log(sum exp(x - m)) + m with m the maximum and
//     -inf where m is -inf (ngsf_hmm_tpu/ops/logsum.py), log and not
//     log1p;
//   * log_trans: the four log transitions of one site (ngsf_hmm_tpu/
//     models/hmm.py:_log_trans_elems), x = exp(-alpha d), 0 at a
//     chromosome break (d = +inf); d = 0 gives the identity, so a pad
//     site (d = 0, emissions 0) is an exact no-op of the forward and
//     backward steps.
// Built with -fmad=false (utils/cuda_lib.py), so no multiply-add is
// contracted behind the plain version's back.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ double log_sum2(double a, double b) {
    const double m = fmax(a, b);
    if (m == -INFINITY) return -INFINITY;
    return log(exp(a - m) + exp(b - m)) + m;
}

__device__ __forceinline__ double log_sum3(double a, double b, double c) {
    const double m = fmax(fmax(a, b), c);
    if (m == -INFINITY) return -INFINITY;
    return log((exp(a - m) + exp(b - m)) + exp(c - m)) + m;
}

// x = exp(-alpha d), 0 at a chromosome break
__device__ __forceinline__ double log_decay(double alpha, double d) {
    return isinf(d) ? 0.0 : exp(-alpha * d);
}

struct LogTrans {
    double t00, t01, t10, t11;
};

__device__ __forceinline__ LogTrans log_trans(double F, double x) {
    const double one_m = 1.0 - x;
    const double q0 = 1.0 - F;
    LogTrans t;
    t.t00 = log(one_m * q0 + x);
    t.t01 = log(one_m * F);
    t.t10 = log(one_m * q0);
    t.t11 = log(one_m * F + x);
    return t;
}
