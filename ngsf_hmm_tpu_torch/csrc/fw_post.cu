// Kernel: forward stream from each block's start vector, reading the
// backward ratio slab and writing the per-site IBD posterior
// p = fw1 r / (fw0 (1 - r) + fw1 r).
// Replaces ngsf_hmm_tpu/models/hmm_pallas.py:_k2_fw_post.
// Bound by bytes: three slabs read, one written.
#include "hmm_common.cuh"

__global__ void k_fw_post(
    const float* __restrict__ g0, const float* __restrict__ g2,
    const float* __restrict__ fc, const float* __restrict__ dc,
    const float* __restrict__ Fp, const float* __restrict__ ap,
    const float* __restrict__ starts,  // [2, nb, N]
    const float* __restrict__ bwr, float* __restrict__ p, int bs, int nb,
    int N) {
    const long long lanes = (long long)nb * N;
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int j = (int)(lane / N);
    const int n = (int)(lane - (long long)j * N);
    const float F = Fp[n];
    const float a = ap[n];
    float v0 = starts[lane], v1 = starts[lanes + lane];

    for (int r0 = 0; r0 < bs; r0 += NGSF_UNROLL) {
        float a0[NGSF_UNROLL], a2[NGSF_UNROLL], ff[NGSF_UNROLL],
            dd[NGSF_UNROLL], rr[NGSF_UNROLL];
        chunk_load(g0, g2, fc, dc, r0, bs, nb, j, lane, lanes, a0, a2, ff, dd);
#pragma unroll
        for (int u = 0; u < NGSF_UNROLL; ++u)
            rr[u] = (r0 + u < bs)
                        ? __ldg(bwr + (long long)(r0 + u) * lanes + lane)
                        : 0.5f;
#pragma unroll
        for (int u = 0; u < NGSF_UNROLL; ++u) {
            const int r = r0 + u;
            if (r < bs) {
                const SiteK k = site_load(a0[u], a2[u], ff[u], dd[u], a);
                float m00, m01, m10, m11;
                site_matrix(k, F, m00, m01, m10, m11);
                const float n0 = v0 * m00 + v1 * m10;
                const float n1 = v0 * m01 + v1 * m11;
                int ex = 0;
                const float sc =
                    pow2_scale(fmaxf(fmaxf(n0, n1), NGSF_TINY), ex);
                v0 = n0 * sc;
                v1 = n1 * sc;
                const float x0 = v0 * (1.0f - rr[u]);
                const float x1 = v1 * rr[u];
                p[(long long)r * lanes + lane] =
                    x1 / fmaxf(x0 + x1, NGSF_TINY);
            }
        }
    }
}

extern "C" int ngsf_fw_post(const float* g0, const float* g2, const float* fc,
                            const float* dc, const float* F,
                            const float* alpha, const float* starts,
                            const float* bwr, float* p, int bs, int nb, int N,
                            void* stream) {
    const int threads = 128;
    const long long lanes = (long long)nb * N;
    const unsigned grid = (unsigned)((lanes + threads - 1) / threads);
    k_fw_post<<<grid, threads, 0, (cudaStream_t)stream>>>(
        g0, g2, fc, dc, F, alpha, starts, bwr, p, bs, nb, N);
    return (int)cudaGetLastError();
}
