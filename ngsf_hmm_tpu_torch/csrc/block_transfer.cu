// Kernel: per-block transfer products for B candidate parameter sets.
// Replaces ngsf_hmm_tpu/models/hmm_pallas.py:_k2_block_transfer.
// Bound by bytes: it reads the two gl slabs once per candidate and writes
// five floats per lane; ~30 float operations per cell.
#include "hmm_common.cuh"

__global__ void k_block_transfer(
    const float* __restrict__ g0, const float* __restrict__ g2,
    const float* __restrict__ fc, const float* __restrict__ dc,
    const float* __restrict__ Fp, const float* __restrict__ ap,
    float* __restrict__ out, int bs, int nb, int N, int B) {
    const long long lanes = (long long)nb * N;
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int b = blockIdx.y;
    const int j = (int)(lane / N);
    const int n = (int)(lane - (long long)j * N);
    const float F = Fp[(long long)b * N + n];
    const float a = ap[(long long)b * N + n];

    float c00 = 1.0f, c01 = 0.0f, c10 = 0.0f, c11 = 1.0f;
    int ex = 0;
    for (int r0 = 0; r0 < bs; r0 += NGSF_UNROLL) {
        float a0[NGSF_UNROLL], a2[NGSF_UNROLL], ff[NGSF_UNROLL],
            dd[NGSF_UNROLL];
        chunk_load(g0, g2, fc, dc, r0, bs, nb, j, lane, lanes, a0, a2, ff, dd);
#pragma unroll
        for (int u = 0; u < NGSF_UNROLL; ++u) {
            const SiteK k = site_load(a0[u], a2[u], ff[u], dd[u], a);
            float m00, m01, m10, m11;
            site_matrix(k, F, m00, m01, m10, m11);
            const float n00 = c00 * m00 + c01 * m10;
            const float n01 = c00 * m01 + c01 * m11;
            const float n10 = c10 * m00 + c11 * m10;
            const float n11 = c10 * m01 + c11 * m11;
            const float sc =
                pow2_scale(fmaxf(max4(n00, n01, n10, n11), NGSF_TINY), ex);
            c00 = n00 * sc;
            c01 = n01 * sc;
            c10 = n10 * sc;
            c11 = n11 * sc;
        }
    }
    // out [5, B, nb, N]
    const long long plane = (long long)B * lanes;
    float* o = out + (long long)b * lanes + lane;
    o[0] = c00;
    o[plane] = c01;
    o[2 * plane] = c10;
    o[3 * plane] = c11;
    o[4 * plane] = (float)ex * NGSF_LN2;
}

extern "C" int ngsf_block_transfer(const float* g0, const float* g2,
                                   const float* fc, const float* dc,
                                   const float* F, const float* alpha,
                                   float* out, int bs, int nb, int N, int B,
                                   void* stream) {
    const int threads = 128;
    const long long lanes = (long long)nb * N;
    dim3 grid((unsigned)((lanes + threads - 1) / threads), (unsigned)B);
    k_block_transfer<<<grid, threads, 0, (cudaStream_t)stream>>>(
        g0, g2, fc, dc, F, alpha, out, bs, nb, N, B);
    return (int)cudaGetLastError();
}
