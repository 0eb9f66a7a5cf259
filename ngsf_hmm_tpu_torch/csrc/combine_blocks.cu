// Kernel: cross-block combine, in two levels. The nb per-block transfer
// products are cut into C chunks of L blocks (L about sqrt(nb)). One CTA
// holds CB_TN neighbouring individuals of one candidate times the C chunks,
// one thread per (chunk, individual):
//   1. each thread forms its chunk's rescaled 2x2 product (the
//      power-of-two rescale after every block, exponents and log-offsets
//      summed on the side) and leaves it in shared memory;
//   2. one thread per individual walks the C chunk products forward (the
//      vector entering each chunk, and ll_f) and another, in another
//      warp, backward (the vector at each chunk's end, and ll_b);
//   3. each thread reruns its chunk's blocks from the vector entering the
//      chunk (writing each block's start vector) and from the vector at
//      its end (writing each block's end vector).
// So the serial chain is L + C + 2 L steps long instead of 2 nb.
// Port-only: the JAX package leaves this step to two XLA associative
// scans over the same rescaled products
// (ngsf_hmm_tpu/models/hmm_pallas.py:_combine_blocks).
// Bound by the SM's loads from L2, not by DRAM bytes: the products
// (5 * nb * N floats) are read three times, a 32-byte sector (a row of
// CB_TN = 8 individuals) at a time, by ceil(N / 8) CTAs.
// No atomics and a fixed order: the result is the same bits on every call,
// and candidate b's result does not depend on B.
//
// The per-block log-offsets and the exponents of the rescales are summed
// in double, so ll_f and ll_b differ only by the float32 rounding of the
// 2x2 products, not by the rounding of a sum near 1e6.
#include <cuda_runtime.h>
#include <math.h>

#define CB_TINY 1e-30f
#define CB_LN2 0.6931471805599453
#define CB_TN 8        // individuals per CTA
// CB_MAXC: chunks per CTA (CB_TN * CB_MAXC threads at most), defined by the
// build from utils/cuda_lib.py COMBINE_MAX_CHUNKS, which also sizes the chunks
#ifndef CB_MAXC
#error "CB_MAXC is defined by the build (utils/cuda_lib.py)"
#endif
#define CB_UNROLL 4    // blocks a group of loads

__device__ __forceinline__ float cb_scale(float mx, int& ex) {
    const int exb = __float_as_int(mx) >> 23;
    ex += exb - 127;
    return __int_as_float((254 - exb) << 23);
}

__device__ __forceinline__ float cb_max4(float a, float b, float c, float d) {
    return fmaxf(fmaxf(a, b), fmaxf(c, d));
}

// Walks blocks j0 .. j1 - 1 (forward, FWD) or j1 - 1 .. j0 (backward),
// calling step(j, m) with block j's first K entries m; the entries of
// CB_UNROLL blocks are loaded before their steps.
template <int K, bool FWD, class Step>
__device__ __forceinline__ void cb_walk(const float* __restrict__ Ab,
                                        long long sj, long long sk, int j0,
                                        int j1, Step step) {
    const int len = j1 - j0;
    for (int i0 = 0; i0 < len; i0 += CB_UNROLL) {
        float m[CB_UNROLL][K];
#pragma unroll
        for (int u = 0; u < CB_UNROLL; ++u)
            if (i0 + u < len) {
                const int j = FWD ? j0 + i0 + u : j1 - 1 - i0 - u;
#pragma unroll
                for (int k = 0; k < K; ++k)
                    m[u][k] = __ldg(Ab + (long long)j * sj + k * sk);
            }
#pragma unroll
        for (int u = 0; u < CB_UNROLL; ++u)
            if (i0 + u < len) step(FWD ? j0 + i0 + u : j1 - 1 - i0 - u, m[u]);
    }
}

// A: element (j, k, b, n) at A[j*sj + k*sk + b*sb + n] (n stride 1).
// starts / ends: [nb, 2, B, N] contiguous. lls: [2, B, N] double.
// Block (ceil(N / CB_TN), B), threads (CB_TN, C).
__global__ void __launch_bounds__(CB_TN * CB_MAXC)
k_combine_blocks(const float* __restrict__ A, long long sj, long long sk,
                 long long sb, const float* __restrict__ Fp,
                 float* __restrict__ starts, float* __restrict__ ends,
                 double* __restrict__ lls, int nb, int L, int B, int N) {
    __shared__ float4 sP[CB_MAXC][CB_TN];   // chunk products
    __shared__ int sE[CB_MAXC][CB_TN];      // their rescale exponents
    __shared__ double sO[CB_MAXC][CB_TN];   // their summed log-offsets
    __shared__ float2 sV[CB_MAXC][CB_TN];   // vector entering each chunk
    __shared__ float2 sW[CB_MAXC][CB_TN];   // vector at each chunk's end
    const int x = threadIdx.x, c = threadIdx.y, C = blockDim.y;
    const int b = blockIdx.y;
    const int n = blockIdx.x * CB_TN + x;
    const bool live = n < N;
    // lanes past N run on column N - 1 and store nothing
    const int nn = live ? n : N - 1;
    const float* Ab = A + (long long)b * sb + nn;
    const long long BN = (long long)B * N;
    const long long t = (long long)b * N + nn;
    const int j0 = c * L, j1 = min(j0 + L, nb);

    // ---- 1. the chunk's product A_j0 ... A_j1-1, from the identity
    {
        float p00 = 1.0f, p01 = 0.0f, p10 = 0.0f, p11 = 1.0f;
        int pe = 0;
        double po = 0.0;
        cb_walk<5, true>(Ab, sj, sk, j0, j1, [&](int, const float (&m)[5]) {
            const float n00 = p00 * m[0] + p01 * m[2];
            const float n01 = p00 * m[1] + p01 * m[3];
            const float n10 = p10 * m[0] + p11 * m[2];
            const float n11 = p10 * m[1] + p11 * m[3];
            po += (double)m[4];
            const float sc =
                cb_scale(fmaxf(cb_max4(n00, n01, n10, n11), CB_TINY), pe);
            p00 = n00 * sc;
            p01 = n01 * sc;
            p10 = n10 * sc;
            p11 = n11 * sc;
        });
        sP[c][x] = make_float4(p00, p01, p10, p11);
        sE[c][x] = pe;
        sO[c][x] = po;
    }
    __syncthreads();

    // ---- 2. the chunk-level scans. The entering vector (q0, q1) and the
    // exit vector (1, 1) are the whole chain's boundary values.
    const float q1 = Fp[t], q0 = 1.0f - q1;
    const int cb = C > 4 ? 4 : C - 1;  // the backward scan's thread row
    if (c == 0) {
        float v0 = q0, v1 = q1;
        int ex = 0;
        double off = 0.0;
        for (int k = 0; k < C; ++k) {
            sV[k][x] = make_float2(v0, v1);
            const float4 P = sP[k][x];
            const float n0 = v0 * P.x + v1 * P.z;
            const float n1 = v0 * P.y + v1 * P.w;
            ex += sE[k][x];
            off += sO[k][x];
            const float sc = cb_scale(fmaxf(fmaxf(n0, n1), CB_TINY), ex);
            v0 = n0 * sc;
            v1 = n1 * sc;
        }
        if (live)
            lls[t] = log((double)v0 + (double)v1) + off + (double)ex * CB_LN2;
    }
    if (c == cb) {
        float w0 = 1.0f, w1 = 1.0f;
        int ex = 0;
        double off = 0.0;
        for (int k = C - 1; k >= 0; --k) {
            sW[k][x] = make_float2(w0, w1);
            const float4 P = sP[k][x];
            const float b0 = P.x * w0 + P.y * w1;
            const float b1 = P.z * w0 + P.w * w1;
            ex += sE[k][x];
            off += sO[k][x];
            const float sc = cb_scale(fmaxf(fmaxf(b0, b1), CB_TINY), ex);
            w0 = b0 * sc;
            w1 = b1 * sc;
        }
        if (live)
            lls[BN + t] = log((double)q0 * (double)w0 + (double)q1 * (double)w1)
                          + off + (double)ex * CB_LN2;
    }
    __syncthreads();

    // ---- 3. the chunk's blocks again: forward from its entering vector
    // (v_{j+1} = v_j . A_j), backward from its exit vector
    // (w_{j-1} = A_j . w_j)
    int ex = 0;  // not needed here
    float v0 = sV[c][x].x, v1 = sV[c][x].y;
    cb_walk<4, true>(Ab, sj, sk, j0, j1, [&](int j, const float (&m)[4]) {
        if (live) {
            starts[(long long)j * 2 * BN + t] = v0;
            starts[(long long)j * 2 * BN + BN + t] = v1;
        }
        const float n0 = v0 * m[0] + v1 * m[2];
        const float n1 = v0 * m[1] + v1 * m[3];
        const float sc = cb_scale(fmaxf(fmaxf(n0, n1), CB_TINY), ex);
        v0 = n0 * sc;
        v1 = n1 * sc;
    });
    float w0 = sW[c][x].x, w1 = sW[c][x].y;
    cb_walk<4, false>(Ab, sj, sk, j0, j1, [&](int j, const float (&m)[4]) {
        if (live) {
            ends[(long long)j * 2 * BN + t] = w0;
            ends[(long long)j * 2 * BN + BN + t] = w1;
        }
        const float b0 = m[0] * w0 + m[1] * w1;
        const float b1 = m[2] * w0 + m[3] * w1;
        const float sc = cb_scale(fmaxf(fmaxf(b0, b1), CB_TINY), ex);
        w0 = b0 * sc;
        w1 = b1 * sc;
    });
}

// L: blocks per chunk; more than CB_MAXC chunks are refused.
extern "C" int ngsf_combine_blocks(const float* A, long long sj, long long sk,
                                   long long sb, const float* F, float* starts,
                                   float* ends, double* lls, int nb, int L,
                                   int B, int N, void* stream) {
    const int C = (nb + L - 1) / L;
    if (C > CB_MAXC || L < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((N + CB_TN - 1) / CB_TN), (unsigned)B);
    k_combine_blocks<<<grid, dim3(CB_TN, C), 0, (cudaStream_t)stream>>>(
        A, sj, sk, sb, F, starts, ends, lls, nb, L, B, N);
    return (int)cudaGetLastError();
}
