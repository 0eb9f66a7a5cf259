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
//
// Bound by bytes: two slabs read, one ratio slab written. The lane-per-
// thread design (four sites of loads a lane in lane order, then four
// sites of arithmetic with nothing in flight) left the loads exposed, as
// it had in block_transfer_grad.cu (chip_smoke.py's probes, PERF.md
// section 7). This design takes that kernel's staging (stream_tiles.cuh):
//   * tiles of NGSF_TG_D sites x the CTA's 128 lanes of both slabs go to
//     shared memory by cp.async, NGSF_TG_STAGES tiles deep, walked from
//     the block's end, so the loads of the next tiles run while the chain
//     works on this one; the per-site freq / dist compacts of the CTA's
//     blocks ride along;
//   * the prior coefficients of site_load are computed once per (site,
//     block), not on every lane (site_prior, then site_emit: the same
//     expressions, so the same bits);
//   * the step is unchanged and unfused (-fmad=false): site_emit,
//     site_matrix, the 2-vector product, pow2_scale at every site; the
//     ratio a true IEEE division, written at each site before its step,
//     neighbouring lanes on neighbouring addresses.
// Each export equals its plain version (models/hmm_kernels.py:_bw_loop)
// bit for bit.
#include "stream_tiles.cuh"

// MEM: the loads alone (chip_smoke.py's probe): the same staging, each
// site's inputs summed instead of stepped; bwr[lane] gets the sum.
template <class Src, bool MEM, int V>
__global__ void __launch_bounds__(NGSF_TG_THREADS)
    k_bw_sites(Src src, const float* __restrict__ Fp,
               const float* __restrict__ ap,
               const float* __restrict__ ends,  // [2, nb, N]
               float* __restrict__ bwr, int bs, int nb, int N, int nbx) {
    using T = typename Src::Elem;
    constexpr int D = NGSF_TG_D, S = NGSF_TG_STAGES, W = NGSF_TG_THREADS;
    extern __shared__ __align__(16) unsigned char smem[];

    const int tid = threadIdx.x;
    const long long lanes = (long long)nb * N;
    const long long l0 = (long long)blockIdx.x * W;
    const long long lane = l0 + tid;
    const bool in_lanes = lane < lanes;
    const long long lc = in_lanes ? lane : lanes - 1;
    const int j = (int)(lc / N);
    const int n = (int)(lc - (long long)j * N);
    const float F = Fp[n];
    const float a = ap[n];
    float w0 = ends[lc], w1 = ends[lanes + lc];
    const int ntiles = (bs + D - 1) / D;
    // tile t holds sites bs - (t + 1) D .. bs - t D - 1 (the last tile
    // starts below site 0)
    StreamTiles<Src, V, -1> tl(src, smem, l0, lanes, tid, bs, nb, N, nbx,
                               bs - D);
    const int jl = j - tl.j0;
    auto issue = [&](int t) {
        if (t < ntiles) tl.issue(t % S, bs - (t + 1) * D);
        cp_async_commit();
    };

#pragma unroll
    for (int t = 0; t < S - 1; ++t) issue(t);
    float acc = 0.0f;
    for (int t = 0; t < ntiles; ++t) {
        cp_async_wait<S - 2>();
        __syncthreads();  // tile t landed; tile t - 1 consumed by all
        issue(t + S - 1);
        const int st = t % S, r0 = bs - (t + 1) * D;
        const T* g0t = tl.tiles + st * 2 * D * W + tid;
        const T* g2t = g0t + D * W;
        const float* dq = tl.compacts(st) + (nbx + jl) * D;  // lane's dist
        if (Src::kFreq && !MEM) tl.priors(st);  // the tile's coefficients
        const float4* cq = tl.coef + 2 * D * jl;  // this lane's block's
        float* out = bwr + (long long)r0 * lanes + lane;
        auto step = [&](int u) {  // site r0 + u
            const float g0 = to_float(g0t[u * W]);
            const float g2 = to_float(g2t[u * W]);
            if (MEM) {
                acc += g0 + g2 + dq[u];
                return;
            }
            if (in_lanes) out[u * lanes] = w1 / fmaxf(w0 + w1, NGSF_TINY);
            SiteK k;
            if constexpr (Src::kFreq) {
                const float4 p = cq[2 * u], s = cq[2 * u + 1];
                const Prior q = {p.x, p.y, p.z, p.w, s.x, s.y, s.z};
                k = site_emit(g0, g2, q, s.w, a);
            } else {
                k = site_em(g0, g2, dq[u], a);
            }
            float m00, m01, m10, m11;
            site_matrix(k, F, m00, m01, m10, m11);
            const float b0 = m00 * w0 + m01 * w1;
            const float b1 = m10 * w0 + m11 * w1;
            int ex = 0;
            const float sc = pow2_scale(fmaxf(fmaxf(b0, b1), NGSF_TINY), ex);
            w0 = b0 * sc;
            w1 = b1 * sc;
        };
        if (r0 >= 0) {
#pragma unroll
            for (int u = D - 1; u >= 0; --u) step(u);
        } else {  // the last tile: sites 0 .. r0 + D - 1
            for (int u = D - 1; u >= -r0; --u) step(u);
        }
    }
    cp_async_wait<0>();
    if (MEM && in_lanes) bwr[lane] = acc;
}

template <class Src, bool MEM = false>
static int launch(Src src, const float* F, const float* alpha,
                  const float* ends, float* bwr, int bs, int nb, int N,
                  void* stream) {
    constexpr int W = NGSF_TG_THREADS;
    const long long lanes = (long long)nb * N;
    const unsigned grid = (unsigned)((lanes + W - 1) / W);
    const int nbx = tg_blocks(N, nb);
    const int smem = tg_smem_bytes<Src>(nbx);
    auto go = [&](auto kern) {
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return (int)e;
        }
        kern<<<grid, W, smem, (cudaStream_t)stream>>>(src, F, alpha, ends,
                                                      bwr, bs, nb, N, nbx);
        return (int)cudaGetLastError();
    };
    switch (tg_copy_width(src, lanes)) {
    case 16: return go(k_bw_sites<Src, MEM, 16>);
    case 8: return go(k_bw_sites<Src, MEM, 8>);
    case 4: return go(k_bw_sites<Src, MEM, 4>);
    case 2:
        if constexpr (sizeof(typename Src::Elem) == 2)
            return go(k_bw_sites<Src, MEM, 2>);
    }
    return (int)cudaErrorInvalidValue;
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
