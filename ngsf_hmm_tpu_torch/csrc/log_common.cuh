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
//     backward steps;
//   * Lx, lx_site, lx_entry: log_block_transfer's linear chain (below),
//     in the order of models/hmm.py:_log_block_transfer_plain.
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


// ---- log_block_transfer's linear chain. A block's 2x2 product is formed
// in linear float64, each entry m * 2^e with m in [1, 2) and its own
// integer exponent e (or m = 0, e = LX_EZERO), so no entry flushes to 0
// where the log-space chain keeps it finite, however far apart a row's
// entries drift (F = 0 or 1, runs of d = 0 sites, -inf emissions); each
// site's larger log emission is summed into a lane offset and the other
// enters as a factor exp(gap) <= 1; the logs are taken once a lane, at the
// block's end: log(m) + e ln 2 + offset.
#define LX_EZERO (-(1 << 29))  // exponent of a zero entry or transition
#define LX_EFLOOR (-(1 << 27))  // a nonzero entry's exponent saturates here
#define LX_DROP 60  // a term 2^-61 of the other is below its half ulp
#define LX_SPLIT (-708.0)  // emission gaps below: the exponent kept apart
#define LX_GAP_MIN (-1048576.0)  // wider gaps (2^20 nats) count as this
#define LX_LN2 0.6931471805599453
#define LX_INV_LN2 1.4426950408889634
#define LX_LN2_HI 6.93147180369123816490e-01  // 32 bits: j * HI exact
#define LX_LN2_LO 1.90821492927058770002e-10
#define LX_TINY 0x1p-1022  // the least normal float64

struct Lx {
    double m;  // in [1, 2), or 0
    int e;
};

// v (>= 0, normal or 0) renormalised: (m, base + its binary exponent),
// the exponent saturated at LX_EFLOOR; v = 0 gives (0, LX_EZERO). Bit
// operations only, exact.
__device__ __forceinline__ Lx lx_norm(double v, int base) {
    const int hi = __double2hiint(v);
    const int ex = hi >> 20;
    Lx r;  // v = 0 has a zero low word: only the high one is selected
    r.m = __hiloint2double(ex == 0 ? 0 : (hi & 0x000FFFFF) | 0x3FF00000,
                           __double2loint(v));
    r.e = ex == 0 ? LX_EZERO : max(base + ex - 1023, LX_EFLOOR);
    return r;
}

// a transition T >= 0 as (m, tau); a subnormal T is scaled by 2^54 first
__device__ __forceinline__ Lx lx_trans(double T) {
    const bool sub = T > 0.0 && T < LX_TINY;
    T = sub ? T * 0x1p54 : T;
    const int hi = __double2hiint(T);
    const int ex = hi >> 20;
    Lx r;  // as in lx_norm; a subnormal T is never left here
    r.m = __hiloint2double(ex == 0 ? 0 : (hi & 0x000FFFFF) | 0x3FF00000,
                           __double2loint(T));
    r.e = ex == 0 ? LX_EZERO : ex - 1023 - (sub ? 54 : 0);
    return r;
}

// 2^k for an integer k <= 0, 0 below -LX_DROP: exact
__device__ __forceinline__ double lx_pow2(int k) {
    return k < -LX_DROP ? 0.0 : __hiloint2double((k + 1023) << 20, 0);
}

// One site of the chain: its four transitions T[k][l], each state's
// emission factor w 2^j and the offset it adds.
struct LxSite {
    Lx t00, t01, t10, t11;
    double w0, w1, off;
    int j0, j1;
};

// The site with decay x (log_decay) and emissions es: an emission gap
// below LX_SPLIT keeps its exponent apart (Cody-Waite: the factor in
// (1/2, 1], its exponent in j).
__device__ __forceinline__ LxSite lx_site(double F, double q0, double x,
                                          double2 es) {
    LxSite st;
    const double one_m = 1.0 - x;
    const double T10 = one_m * q0, T01 = one_m * F;
    st.t00 = lx_trans(T10 + x);
    st.t01 = lx_trans(T01);
    st.t10 = lx_trans(T10);
    st.t11 = lx_trans(T01 + x);
    const bool first = es.x >= es.y;  // state 0 holds the larger (ties)
    const double hi = first ? es.x : es.y, lo = first ? es.y : es.x;
    const bool dead = hi == -INFINITY;
    const double hs = dead ? 0.0 : hi;
    const double g = lo - hs;
    double w;
    int j = 0;
    if (g < LX_SPLIT && g > -INFINITY) {
        const double gc = fmax(g, LX_GAP_MIN);
        j = (int)(gc * LX_INV_LN2);
        w = exp((gc - j * LX_LN2_HI) - j * LX_LN2_LO);
    } else {
        w = exp(g);
    }
    const double one = dead ? 0.0 : 1.0;
    st.w0 = first ? one : w;
    st.w1 = first ? w : one;
    st.j0 = first ? 0 : j;
    st.j1 = first ? j : 0;
    st.off = hs;
    return st;
}

// Entry (k, l) after a site: a0, a1 the row's entries of states 0 and 1,
// t0 = T[0][l], t1 = T[1][l], (w, j) state l's emission factor. The larger
// product keeps its exponent, the other is scaled to it (or dropped, 2^-61
// below it); the sum times w is renormalised.
__device__ __forceinline__ Lx lx_entry(Lx a0, Lx a1, Lx t0, Lx t1, double w,
                                       int j) {
    const int P0 = a0.e + t0.e, P1 = a1.e + t1.e, Pm = max(P0, P1);
    const double s = (a0.m * t0.m) * lx_pow2(P0 - Pm) +
                     (a1.m * t1.m) * lx_pow2(P1 - Pm);
    return lx_norm(s * w, Pm + j);
}
