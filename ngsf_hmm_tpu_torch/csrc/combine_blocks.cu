// Kernel: cross-block combine. One thread per (candidate b, individual n)
// walks the nb per-block transfer products forward (the vector entering
// each block, and the forward log-likelihood) and backward (the vector at
// each block's last site, and the backward log-likelihood).
// Port-only: the JAX package leaves this step to two XLA associative
// scans (ngsf_hmm_tpu/models/hmm_pallas.py:_combine_blocks).
// Bound by latency, not bytes: B*N threads each run a 2*nb-step chain;
// the products are prefetched a chunk ahead of the carry.
//
// The per-block log-offsets and the exponents of the rescales here are
// summed in double, so ll_f and ll_b differ only by the float32 rounding
// of the 2x2 products, not by the rounding of a sum near 1e6.
#include <cuda_runtime.h>
#include <math.h>

#define CB_TINY 1e-30f
#define CB_LN2 0.6931471805599453
#define CB_UNROLL 8

__device__ __forceinline__ float cb_scale(float mx, long long& ex) {
    const int exb = __float_as_int(mx) >> 23;
    ex += exb - 127;
    return __int_as_float((254 - exb) << 23);
}

// A: element (j, k, b, n) at A[j*sj + k*sk + b*sb + n] (n stride 1).
// starts / ends: [nb, 2, B, N] contiguous. lls: [2, B, N] double.
__global__ void k_combine_blocks(const float* __restrict__ A, long long sj,
                                 long long sk, long long sb,
                                 const float* __restrict__ Fp,
                                 float* __restrict__ starts,
                                 float* __restrict__ ends,
                                 double* __restrict__ lls, int nb, int B,
                                 int N) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B * N) return;
    const int b = t / N, n = t - b * N;
    const float* Ab = A + (long long)b * sb + n;
    const long long BN = (long long)B * N;
    const float q1 = Fp[t], q0 = 1.0f - q1;

    // forward: v_{j+1} = v_j . A_j
    float v0 = q0, v1 = q1;
    long long ex = 0;
    double off = 0.0;
    for (int j0 = 0; j0 < nb; j0 += CB_UNROLL) {
        float m[CB_UNROLL][5];
#pragma unroll
        for (int u = 0; u < CB_UNROLL; ++u)
            if (j0 + u < nb) {
#pragma unroll
                for (int k = 0; k < 5; ++k)
                    m[u][k] = __ldg(Ab + (long long)(j0 + u) * sj + k * sk);
            }
#pragma unroll
        for (int u = 0; u < CB_UNROLL; ++u) {
            const int j = j0 + u;
            if (j < nb) {
                starts[(long long)j * 2 * BN + t] = v0;
                starts[(long long)j * 2 * BN + BN + t] = v1;
                const float n0 = v0 * m[u][0] + v1 * m[u][2];
                const float n1 = v0 * m[u][1] + v1 * m[u][3];
                off += (double)m[u][4];
                const float sc = cb_scale(fmaxf(fmaxf(n0, n1), CB_TINY), ex);
                v0 = n0 * sc;
                v1 = n1 * sc;
            }
        }
    }
    lls[t] = log((double)v0 + (double)v1) + off + (double)ex * CB_LN2;

    // backward: w_{j-1} = A_j . w_j, from w = (1, 1) at the last block's end
    float w0 = 1.0f, w1 = 1.0f;
    ex = 0;
    off = 0.0;
    const int nchunk = (nb + CB_UNROLL - 1) / CB_UNROLL;
    for (int c = nchunk - 1; c >= 0; --c) {
        const int j0 = c * CB_UNROLL;
        float m[CB_UNROLL][5];
#pragma unroll
        for (int u = 0; u < CB_UNROLL; ++u)
            if (j0 + u < nb) {
#pragma unroll
                for (int k = 0; k < 5; ++k)
                    m[u][k] = __ldg(Ab + (long long)(j0 + u) * sj + k * sk);
            }
#pragma unroll
        for (int u = CB_UNROLL - 1; u >= 0; --u) {
            const int j = j0 + u;
            if (j < nb) {
                ends[(long long)j * 2 * BN + t] = w0;
                ends[(long long)j * 2 * BN + BN + t] = w1;
                const float b0 = m[u][0] * w0 + m[u][1] * w1;
                const float b1 = m[u][2] * w0 + m[u][3] * w1;
                off += (double)m[u][4];
                const float sc = cb_scale(fmaxf(fmaxf(b0, b1), CB_TINY), ex);
                w0 = b0 * sc;
                w1 = b1 * sc;
            }
        }
    }
    lls[BN + t] =
        log((double)q0 * (double)w0 + (double)q1 * (double)w1) + off +
        (double)ex * CB_LN2;
}

extern "C" int ngsf_combine_blocks(const float* A, long long sj, long long sk,
                                   long long sb, const float* F, float* starts,
                                   float* ends, double* lls, int nb, int B,
                                   int N, void* stream) {
    const int threads = 32;
    const unsigned grid = (unsigned)((B * N + threads - 1) / threads);
    k_combine_blocks<<<grid, threads, 0, (cudaStream_t)stream>>>(
        A, sj, sk, sb, F, starts, ends, lls, nb, B, N);
    return (int)cudaGetLastError();
}
