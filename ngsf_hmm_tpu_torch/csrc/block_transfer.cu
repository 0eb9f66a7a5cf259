// Kernel: per-block transfer products for B candidate parameter sets.
// One template over the emission source (hmm_common.cuh), three exports:
//   ngsf_block_transfer     (GlSource) replaces
//                           ngsf_hmm_tpu/models/hmm_pallas.py:_k2_block_transfer
//   ngsf_block_transfer_bf16  the same on bfloat16 gl slabs
//   ngsf_block_transfer_v1  (EmSource) replaces
//                           ngsf_hmm_tpu/models/hmm_pallas.py:_k_block_transfer
// Bound by bytes: it reads the two slabs once per candidate and writes
// five floats per lane; ~30 float operations per cell.
#include "hmm_common.cuh"

template <class Src>
__global__ void k_block_transfer(Src src, const float* __restrict__ Fp,
                                 const float* __restrict__ ap,
                                 float* __restrict__ out, int bs, int nb,
                                 int N, int B) {
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
        chunk_load(src, r0, bs, nb, j, lane, lanes, a0, a2, ff, dd);
#pragma unroll
        for (int u = 0; u < NGSF_UNROLL; ++u) {
            const SiteK k = src.site(a0[u], a2[u], ff[u], dd[u], a);
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

template <class Src>
static int launch(Src src, const float* F, const float* alpha, float* out,
                  int bs, int nb, int N, int B, void* stream) {
    const int threads = 128;
    const long long lanes = (long long)nb * N;
    dim3 grid((unsigned)((lanes + threads - 1) / threads), (unsigned)B);
    k_block_transfer<<<grid, threads, 0, (cudaStream_t)stream>>>(
        src, F, alpha, out, bs, nb, N, B);
    return (int)cudaGetLastError();
}

extern "C" int ngsf_block_transfer(const float* g0, const float* g2,
                                   const float* fc, const float* dc,
                                   const float* F, const float* alpha,
                                   float* out, int bs, int nb, int N, int B,
                                   void* stream) {
    return launch(GlSource<float>{g0, g2, fc, dc}, F, alpha, out, bs, nb, N,
                  B, stream);
}

extern "C" int ngsf_block_transfer_bf16(const __nv_bfloat16* g0,
                                        const __nv_bfloat16* g2,
                                        const float* fc, const float* dc,
                                        const float* F, const float* alpha,
                                        float* out, int bs, int nb, int N,
                                        int B, void* stream) {
    return launch(GlSource<__nv_bfloat16>{g0, g2, fc, dc}, F, alpha, out, bs,
                  nb, N, B, stream);
}

extern "C" int ngsf_block_transfer_v1(const float* e0, const float* e1,
                                      const float* dc, const float* F,
                                      const float* alpha, float* out, int bs,
                                      int nb, int L, int B, void* stream) {
    return launch(EmSource{e0, e1, nullptr, dc}, F, alpha, out, bs, nb, L, B,
                  stream);
}
