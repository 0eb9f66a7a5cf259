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
// Templated on the float type: the scan tier runs in float64 or float32,
// as the state is; maf_log's float32 instance also serves --freq e on the
// fused tier. Built with -fmad=false (utils/cuda_lib.py), so no
// multiply-add is contracted behind the plain version's back.
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
template <typename T>
__device__ __forceinline__ T log_decay(T alpha, T d) {
    return isinf(d) ? (T)0 : lc_exp(-alpha * d);
}

template <typename T>
struct LogTrans {
    T t00, t01, t10, t11;
};

template <typename T>
__device__ __forceinline__ LogTrans<T> log_trans(T F, T x) {
    const T one_m = (T)1 - x;
    const T q0 = (T)1 - F;
    LogTrans<T> t;
    t.t00 = lc_log(one_m * q0 + x);
    t.t01 = lc_log(one_m * F);
    t.t10 = lc_log(one_m * q0);
    t.t11 = lc_log(one_m * F + x);
    return t;
}


// ---- log_block_transfer's linear chain. A block's 2x2 product is formed
// in linear arithmetic of the tier's float type, each entry m * 2^e with m
// in [1, 2) and its own integer exponent e (or m = 0, e = LX_EZERO), so
// no entry flushes to 0 where the log-space chain keeps it finite, however
// far apart a row's entries drift (F = 0 or 1, runs of d = 0 sites, -inf
// emissions); each site's larger log emission is summed into a lane
// offset and the other enters as a factor exp(gap) <= 1; the logs are
// taken once a lane, at the block's end: log(m) + e ln 2 + offset. The
// integer exponents are the same for both float types: a site lowers an
// entry's by at most the 1,075 (float64) or 150 (float32) of a subnormal
// transition plus its emission gap's j (below), so the saturation at
// LX_EFLOOR keeps every sum of two exponents inside an int, and a zero's
// LX_EZERO below every nonzero one.
#define LX_EZERO (-(1 << 29))  // exponent of a zero entry or transition
#define LX_EFLOOR (-(1 << 27))  // a nonzero entry's exponent saturates here

// The constants of each float type. DROP: a product 2^(-DROP-1) or less of
// the other, both in [1, 4), is below half an ulp of the sum, so dropping
// it gives the sum's bits. SPLIT: emission gaps below it (exp's normal
// range ends there) keep their exponent apart, j = trunc(gap / ln 2) and
// the factor exp(gap - j ln 2) about (1/2, 1] (Cody-Waite, HI + LO = ln 2;
// the rounded quotient may put j one off, the factor then up to about
// 1.1 or down to 0.45, still normal);
// GAP_MIN: wider gaps count as this one (2^20 nats: 1,512,775 halvings).
template <typename T>
struct LxK;

template <>
struct LxK<double> {
    static constexpr int DROP = 60, BIAS = 1023, SUB = 54;
    static constexpr double SPLIT = -708.0, GAP_MIN = -1048576.0,
                            LN2 = 0.6931471805599453,
                            INV_LN2 = 1.4426950408889634,
                            // 32 bits: j * HI exact for |j| < 2^21
                            LN2_HI = 6.93147180369123816490e-01,
                            LN2_LO = 1.90821492927058770002e-10,
                            TINY = 0x1p-1022, SCALE = 0x1p54;
};

template <>
struct LxK<float> {
    static constexpr int DROP = 25, BIAS = 127, SUB = 24;
    static constexpr float SPLIT = -87.0f, GAP_MIN = -1048576.0f,
                           LN2 = 0x1.62e430p-1f,  // ln 2 rounded
                           INV_LN2 = 0x1.715476p+0f,
                           LN2_HI = 0x1.62e430p-1f,  // ln 2 rounded
                           LN2_LO = -0x1.05c61p-29f,  // ln 2 - HI rounded
                           TINY = 0x1p-126f, SCALE = 0x1p24f;
};

template <typename T>
struct Lx {
    T m;  // in [1, 2), or 0
    int e;
};

// v (>= 0, normal or 0) renormalised: (m, base + its binary exponent),
// the exponent saturated at LX_EFLOOR; v = 0 gives (0, LX_EZERO). Bit
// operations only, exact.
__device__ __forceinline__ Lx<double> lx_norm(double v, int base) {
    const int hi = __double2hiint(v);
    const int ex = hi >> 20;
    Lx<double> r;  // v = 0 has a zero low word: only the high one is selected
    r.m = __hiloint2double(ex == 0 ? 0 : (hi & 0x000FFFFF) | 0x3FF00000,
                           __double2loint(v));
    r.e = ex == 0 ? LX_EZERO : max(base + ex - 1023, LX_EFLOOR);
    return r;
}

__device__ __forceinline__ Lx<float> lx_norm(float v, int base) {
    const int b = __float_as_int(v);
    const int ex = b >> 23;
    Lx<float> r;
    r.m = __int_as_float(ex == 0 ? 0 : (b & 0x007FFFFF) | 0x3F800000);
    r.e = ex == 0 ? LX_EZERO : max(base + ex - 127, LX_EFLOOR);
    return r;
}

// a transition T >= 0 as (m, tau); a subnormal T is scaled by 2^SUB first
// (then normal), which tau takes off again
__device__ __forceinline__ Lx<double> lx_trans(double T) {
    const bool sub = T > 0.0 && T < LxK<double>::TINY;
    T = sub ? T * LxK<double>::SCALE : T;
    const int hi = __double2hiint(T);
    const int ex = hi >> 20;
    Lx<double> r;  // as in lx_norm; a subnormal T is never left here
    r.m = __hiloint2double(ex == 0 ? 0 : (hi & 0x000FFFFF) | 0x3FF00000,
                           __double2loint(T));
    r.e = ex == 0 ? LX_EZERO : ex - 1023 - (sub ? LxK<double>::SUB : 0);
    return r;
}

__device__ __forceinline__ Lx<float> lx_trans(float T) {
    const bool sub = T > 0.0f && T < LxK<float>::TINY;
    T = sub ? T * LxK<float>::SCALE : T;
    const int b = __float_as_int(T);
    const int ex = b >> 23;
    Lx<float> r;
    r.m = __int_as_float(ex == 0 ? 0 : (b & 0x007FFFFF) | 0x3F800000);
    r.e = ex == 0 ? LX_EZERO : ex - 127 - (sub ? LxK<float>::SUB : 0);
    return r;
}

// 2^k for an integer k <= 0, 0 below -DROP: exact
__device__ __forceinline__ double lx_pow2(int k, double) {
    return k < -LxK<double>::DROP ? 0.0
                                  : __hiloint2double((k + 1023) << 20, 0);
}

__device__ __forceinline__ float lx_pow2(int k, float) {
    return k < -LxK<float>::DROP ? 0.0f : __int_as_float((k + 127) << 23);
}

// exp(gc - j ln 2) for the gap gc (>= GAP_MIN) and j = trunc(gc / ln 2).
// float64: j * HI is exact (32-bit HI, |j| < 2^21) and gc - j * HI by
// Sterbenz. float32 has no room for a short HI: gc - j * HI with the
// rounded ln 2 is one fused multiply-add, exact because its value is a
// multiple of 2^-24 (HI's and gc's grid, |gc| >= 87) below 1 in magnitude
// (|j| <= 1,512,775 < 2^24 is a float, |j (ln 2 - HI)| < 0.003 and the
// float32 quotient leaves j within 0.2 of gc / ln 2's truncation), so
// the one rounding leaves it as it is; the plain version forms it in
// float64, where the product (45 bits) and the difference are exact too.
__device__ __forceinline__ double lx_reduce(double gc, int j) {
    return exp((gc - j * LxK<double>::LN2_HI) - j * LxK<double>::LN2_LO);
}

__device__ __forceinline__ float lx_reduce(float gc, int j) {
    const float jf = (float)j;
    return expf(__fmaf_rn(-jf, LxK<float>::LN2_HI, gc) -
                jf * LxK<float>::LN2_LO);
}

// One site of the chain: its four transitions T[k][l], each state's
// emission factor w 2^j and the offset it adds.
template <typename T>
struct LxSite {
    Lx<T> t00, t01, t10, t11;
    T w0, w1, off;
    int j0, j1;
};

// The site with decay x (log_decay) and emissions (e0, e1): an emission
// gap below SPLIT keeps its exponent apart (Cody-Waite: the factor about
// (1/2, 1], its exponent in j).
template <typename T>
__device__ __forceinline__ LxSite<T> lx_site(T F, T q0, T x, T e0, T e1) {
    LxSite<T> st;
    const T one_m = (T)1 - x;
    const T T10 = one_m * q0, T01 = one_m * F;
    st.t00 = lx_trans(T10 + x);
    st.t01 = lx_trans(T01);
    st.t10 = lx_trans(T10);
    st.t11 = lx_trans(T01 + x);
    const bool first = e0 >= e1;  // state 0 holds the larger (ties)
    const T hi = first ? e0 : e1, lo = first ? e1 : e0;
    const bool dead = hi == (T)-INFINITY;
    const T hs = dead ? (T)0 : hi;
    const T g = lo - hs;
    T w;
    int j = 0;
    if (g < LxK<T>::SPLIT && g > (T)-INFINITY) {
        const T gc = lc_max(g, LxK<T>::GAP_MIN);
        j = (int)(gc * LxK<T>::INV_LN2);
        w = lx_reduce(gc, j);
    } else {
        w = lc_exp(g);
    }
    const T one = dead ? (T)0 : (T)1;
    st.w0 = first ? one : w;
    st.w1 = first ? w : one;
    st.j0 = first ? 0 : j;
    st.j1 = first ? j : 0;
    st.off = hs;
    return st;
}

// Entry (k, l) after a site: a0, a1 the row's entries of states 0 and 1,
// t0 = T[0][l], t1 = T[1][l], (w, j) state l's emission factor. The larger
// product keeps its exponent, the other is scaled to it (or dropped, DROP
// + 1 halvings below it); the sum times w is renormalised.
template <typename T>
__device__ __forceinline__ Lx<T> lx_entry(Lx<T> a0, Lx<T> a1, Lx<T> t0,
                                          Lx<T> t1, T w, int j) {
    const int P0 = a0.e + t0.e, P1 = a1.e + t1.e, Pm = max(P0, P1);
    const T s = (a0.m * t0.m) * lx_pow2(P0 - Pm, T()) +
                (a1.m * t1.m) * lx_pow2(P1 - Pm, T());
    return lx_norm(s * w, Pm + j);
}
