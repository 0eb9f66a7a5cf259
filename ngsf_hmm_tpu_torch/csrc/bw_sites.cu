// Kernel: reversed stream from each block's end vector, writing the
// per-site backward ratio r = bw1 / (bw0 + bw1).
// One template over the emission source (hmm_common.cuh), three exports:
//   ngsf_bw_sites     (GlSource) replaces
//                     ngsf_hmm_tpu/models/hmm_pallas.py:_k2_bw_sites
//   ngsf_bw_sites_bf16  the same on bfloat16 gl slabs
//   ngsf_bw_sites_v1  (EmSource) replaces
//                     ngsf_hmm_tpu/models/hmm_pallas.py:_k_bw_sites
//                     (which writes bw0 and bw1; the posterior needs only
//                     their ratio)
// Bound by bytes: two slabs read, one ratio slab written.
#include "hmm_common.cuh"

template <class Src>
__global__ void k_bw_sites(Src src, const float* __restrict__ Fp,
                           const float* __restrict__ ap,
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
        chunk_load(src, r0, bs, nb, j, lane, lanes, a0, a2, ff, dd);
#pragma unroll
        for (int u = NGSF_UNROLL - 1; u >= 0; --u) {
            const int r = r0 + u;
            if (r < bs) {
                bwr[(long long)r * lanes + lane] =
                    w1 / fmaxf(w0 + w1, NGSF_TINY);
                const SiteK k = src.site(a0[u], a2[u], ff[u], dd[u], a);
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

template <class Src>
static int launch(Src src, const float* F, const float* alpha,
                  const float* ends, float* bwr, int bs, int nb, int N,
                  void* stream) {
    const int threads = 128;
    const long long lanes = (long long)nb * N;
    const unsigned grid = (unsigned)((lanes + threads - 1) / threads);
    k_bw_sites<<<grid, threads, 0, (cudaStream_t)stream>>>(
        src, F, alpha, ends, bwr, bs, nb, N);
    return (int)cudaGetLastError();
}

extern "C" int ngsf_bw_sites(const float* g0, const float* g2,
                             const float* fc, const float* dc, const float* F,
                             const float* alpha, const float* ends, float* bwr,
                             int bs, int nb, int N, void* stream) {
    return launch(GlSource<float>{g0, g2, fc, dc}, F, alpha, ends, bwr, bs,
                  nb, N, stream);
}

extern "C" int ngsf_bw_sites_bf16(const __nv_bfloat16* g0,
                                  const __nv_bfloat16* g2, const float* fc,
                                  const float* dc, const float* F,
                                  const float* alpha, const float* ends,
                                  float* bwr, int bs, int nb, int N,
                                  void* stream) {
    return launch(GlSource<__nv_bfloat16>{g0, g2, fc, dc}, F, alpha, ends,
                  bwr, bs, nb, N, stream);
}

extern "C" int ngsf_bw_sites_v1(const float* e0, const float* e1,
                                const float* dc, const float* F,
                                const float* alpha, const float* ends,
                                float* bwr, int bs, int nb, int L,
                                void* stream) {
    return launch(EmSource{e0, e1, nullptr, dc}, F, alpha, ends, bwr, bs, nb,
                  L, stream);
}
