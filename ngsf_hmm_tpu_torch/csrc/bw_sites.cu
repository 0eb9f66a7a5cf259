// Kernel: reversed stream from each block's end vector, writing the
// per-site backward ratio r = bw1 / (bw0 + bw1).
// Replaces ngsf_hmm_tpu/models/hmm_pallas.py:_k2_bw_sites.
// Bound by bytes: two gl slabs read, one ratio slab written.
#include "hmm_common.cuh"

__global__ void k_bw_sites(
    const float* __restrict__ g0, const float* __restrict__ g2,
    const float* __restrict__ fc, const float* __restrict__ dc,
    const float* __restrict__ Fp, const float* __restrict__ ap,
    const float* __restrict__ ends,  // [2, nb, N]
    float* __restrict__ bwr, int bs, int nb, int N) {
    const long long lanes = (long long)nb * N;
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int j = (int)(lane / N);
    const int n = (int)(lane - (long long)j * N);
    const float F = Fp[n];
    const float a = ap[n];
    float w0 = ends[lane], w1 = ends[lanes + lane];

    // chunks are walked from the block's end; within a chunk u runs down
    const int nchunk = (bs + NGSF_UNROLL - 1) / NGSF_UNROLL;
    for (int c = nchunk - 1; c >= 0; --c) {
        const int r0 = c * NGSF_UNROLL;
        float a0[NGSF_UNROLL], a2[NGSF_UNROLL], ff[NGSF_UNROLL],
            dd[NGSF_UNROLL];
        chunk_load(g0, g2, fc, dc, r0, bs, nb, j, lane, lanes, a0, a2, ff, dd);
#pragma unroll
        for (int u = NGSF_UNROLL - 1; u >= 0; --u) {
            const int r = r0 + u;
            if (r < bs) {
                bwr[(long long)r * lanes + lane] =
                    w1 / fmaxf(w0 + w1, NGSF_TINY);
                const SiteK k = site_load(a0[u], a2[u], ff[u], dd[u], a);
                float m00, m01, m10, m11;
                site_matrix(k, F, m00, m01, m10, m11);
                const float b0 = m00 * w0 + m01 * w1;
                const float b1 = m10 * w0 + m11 * w1;
                int ex = 0;
                const float sc =
                    pow2_scale(fmaxf(fmaxf(b0, b1), NGSF_TINY), ex);
                w0 = b0 * sc;
                w1 = b1 * sc;
            }
        }
    }
}

extern "C" int ngsf_bw_sites(const float* g0, const float* g2,
                             const float* fc, const float* dc, const float* F,
                             const float* alpha, const float* ends, float* bwr,
                             int bs, int nb, int N, void* stream) {
    const int threads = 128;
    const long long lanes = (long long)nb * N;
    const unsigned grid = (unsigned)((lanes + threads - 1) / threads);
    k_bw_sites<<<grid, threads, 0, (cudaStream_t)stream>>>(
        g0, g2, fc, dc, F, alpha, ends, bwr, bs, nb, N);
    return (int)cudaGetLastError();
}
