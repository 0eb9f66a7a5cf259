// Log-space helpers shared by the scan tier's kernels (log_chain.cu,
// maf_log.cu), each in the operation order of its plain PyTorch version
// and of the JAX package's float64 tier, so that the kernels and their
// plain versions differ only by the rounding of the libraries' exp and
// log:
//   * logsum2 / logsum3: log(sum exp(x - m)) + m with m the maximum and
//     -inf where m is -inf (ngsf_hmm_tpu/ops/logsum.py), log and not
//     log1p. The maximum term's exp(x - m) is exp(+0.0) for a finite m,
//     which is 1.0 exactly (CUDA's exp and torch.exp alike), so it is
//     not computed: the literal 1.0 stands in its place of the sum, plus
//     m - m (+0.0 for a finite m, NaN where m is +inf, as exp(inf - inf)
//     was), so the bits are the old form's on every input (NaN too) and
//     one exp of each sum goes away;
//   * log_trans: the four log transitions of one site (ngsf_hmm_tpu/
//     models/hmm.py:_log_trans_elems), x = exp(-alpha d), 0 at a
//     chromosome break (d = +inf); d = 0 gives the identity, so a pad
//     site (d = 0, emissions 0) is an exact no-op of the forward and
//     backward steps.
// Templated on the float type (float64 on the scan tier; maf_log also
// builds a float32 instance). Built with -fmad=false (utils/cuda_lib.py),
// so no multiply-add is contracted behind the plain version's back.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ float lc_log(float x) { return logf(x); }
__device__ __forceinline__ double lc_log(double x) { return log(x); }
__device__ __forceinline__ float lc_exp(float x) { return expf(x); }
__device__ __forceinline__ double lc_exp(double x) { return exp(x); }
__device__ __forceinline__ float lc_max(float a, float b) {
    return fmaxf(a, b);
}
__device__ __forceinline__ double lc_max(double a, double b) {
    return fmax(a, b);
}

// log(exp(a) + exp(b)): the term equal to m is 1 (+ m - m), the other one
// exp; a two-term sum is the same either way round.
template <typename T>
__device__ __forceinline__ T log_sum2(T a, T b) {
    const T m = lc_max(a, b);
    if (m == (T)-INFINITY) return (T)-INFINITY;
    const T e = lc_exp((a == m ? b : a) - m);
    return lc_log((T)1 + (m - m) + e) + m;
}

// log((exp(a) + exp(b)) + exp(c)) in that association: the first term
// equal to m is 1 (+ m - m), the other two exp, each in its place.
template <typename T>
__device__ __forceinline__ T log_sum3(T a, T b, T c) {
    const T m = lc_max(lc_max(a, b), c);
    if (m == (T)-INFINITY) return (T)-INFINITY;
    const T one = (T)1 + (m - m);
    const bool am = a == m, abm = am || b == m;  // the maximum is a or b
    const T ex = lc_exp((am ? b : a) - m), ey = lc_exp((abm ? c : b) - m);
    return lc_log(abm ? (one + ex) + ey : (ex + ey) + one) + m;
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
