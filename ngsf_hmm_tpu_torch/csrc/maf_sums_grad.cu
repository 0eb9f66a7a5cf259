// Kernel B of the freq M-step: one evaluation of the cross-individual
// sums and their freq-derivatives (cn, cd, dcn, dcd) at a given per-site
// freq, once per macro round after the first.
// Replaces ngsf_hmm_tpu/ops/maf_pallas.py:_run_sums_grad_slab. Two
// exports: ngsf_maf_sums_grad on float32 gl slabs, ngsf_maf_sums_grad_bf16
// on bfloat16 ones (upcast at load).
//
// Bound by bytes: three slabs read once (12 bytes a cell, 8 on bfloat16
// gl) against about 54 float operations a cell. The design of a warp a
// site (four cells a lane, their loads all issued before any arithmetic,
// nothing else in flight) left the loads exposed (PERF.md section 7).
// This design streams:
//   * a site's N cells are contiguous in each slab, and so are
//     consecutive sites, so a tile of TS = 256 / G sites is one contiguous
//     run of each slab; tiles go to shared memory by 16-byte cp.async
//     (cp_async.cuh; narrower where the slabs' addresses are), with the
//     sites' freq, NGSF_SG_STAGES tiles deep, and a persistent grid walks
//     the tiles while the next ones load;
//   * G lanes a site (8, 16 or 32, chosen from N and the gl width by
//     ops/maf_kernels.py:sums_grad_geometry), TS sites a CTA at a time:
//     lane l of a segment takes cells l, l + G, ... and a log2(G)-step
//     butterfly on the segment sums them (seg_sum);
//   * each cell's planes are built right after its load and used at once
//     (kernel B evaluates a cell once), so no planes are kept in registers;
//   * each cell fused (maf_cell_fma) with the reciprocal from rcp_fast, its
//     range tested once for all the warp's cells; out of range, the warp
//     evaluates its sites again with the exact reciprocal (the same bits
//     where rcp_fast is exact): the cells of kernel A, summed in kernel
//     A's order, so at kernel A's lane geometry the two give the same
//     bits at the same freq;
//   * the four rows written once a site.
// Where three tiles of the narrowest segments (G = 32, 8 sites) do not
// fit a CTA's shared memory (more than 806 individuals on float32 gl,
// 1,210 on bfloat16), the lanes read their cells from global memory
// directly (V = 0).
// The sums over individuals run in another order than the plain version's
// torch.sum, and fused: chip_smoke.py holds the kernel to it at MAF_RTOL.
#include <cstdint>

#include "cp_async.cuh"
#include "maf_common.cuh"

#define NGSF_SG_THREADS 256  // threads a CTA
#define NGSF_SG_STAGES 3     // tiles in flight
#define NGSF_SG_SMEM 232448  // most shared memory a CTA may ask for (H100)

// Bytes of one stage, TS sites of N cells: the g0 and g2 rows [TS, N]
// (esz bytes each), the posterior rows [TS, N] (float), the sites' freq
// [TS]; a multiple of 16. ops/maf_kernels.py:sums_grad_geometry repeats it.
__host__ __device__ inline int sg_stage_bytes(int ts, int N, int esz) {
    const long long cells = (long long)ts * N;
    return (int)((cells * (2 * esz + 4) + 4 * ts + 15) / 16 * 16);
}

// V bytes from global to shared memory, src_bytes of them read (the rest
// zero-filled): cp.async for V of 16, 8 or 4; a plain 2-byte copy for
// slabs not 4-byte aligned.
template <int V>
__device__ __forceinline__ void sg_copy(unsigned char* dst,
                                        const unsigned char* src,
                                        int src_bytes) {
    if constexpr (V >= 4) {
        cp_async<V>(dst, src, src_bytes);
    } else {
        *reinterpret_cast<unsigned short*>(dst) =
            src_bytes ? *reinterpret_cast<const unsigned short*>(src) : 0;
    }
}

// The sums of the site of this lane's segment at freq f, written to out
// [4, sites]; cell(n, g0, g2, F) reads cell n of the site. Every lane of
// the warp calls it; an invalid site (past the last) reads nothing.
template <int G, class Cell>
__device__ __forceinline__ void sg_site(const Cell& cell, bool valid, int N,
                                        int gl, float f, float* out,
                                        long long sites, long long site) {
    const float g = __fmaf_rn(-f, f, f);
    float a = 0.0f, b = 0.0f, da = 0.0f, db = 0.0f, t = 0.0f;
    float lo = 1.0f, hi = 1.0f;  // the denominators' range
    if (valid) {
#pragma unroll 4
        for (int n = gl; n < N; n += G) {
            float x0, x2, F;
            cell(n, x0, x2, F);
            const MafPlanes q = maf_planes(x0, x2, F);
            const float dn = maf_den(q, f);
            lo = fminf(lo, dn);
            hi = fmaxf(hi, dn);
            maf_cell_fma<true>(q, f, g, rcp_fast(dn), a, b, da, db);
            t += 2.0f - F;
        }
    }
    if (!__all_sync(0xffffffffu,
                    lo >= NGSF_RCP_FAST_LO && hi < NGSF_RCP_FAST_HI)) {
        a = b = da = db = 0.0f;
        if (valid) {
            for (int n = gl; n < N; n += G) {
                float x0, x2, F;
                cell(n, x0, x2, F);
                const MafPlanes q = maf_planes(x0, x2, F);
                maf_cell_fma<true>(q, f, g, 1.0f / maf_den(q, f), a, b, da,
                                   db);
            }
        }
    }
    const float cn = seg_sum<G>(a), cd = seg_sum<G>(t) + seg_sum<G>(b);
    const float dcn = seg_sum<G>(da), dcd = seg_sum<G>(db);
    const float v = gl == 0 ? cn : gl == 1 ? cd : gl == 2 ? dcn : dcd;
    if (valid && gl < 4) out[(long long)gl * sites + site] = v;
}

// G lanes a site, TS = NGSF_SG_THREADS / G sites a tile; tile k of the
// CTA is tile blockIdx.x + k gridDim.x. V: bytes a copy (0: no staging).
template <int G, int V, class T>
__global__ void __launch_bounds__(NGSF_SG_THREADS)
    k_maf_sums_grad(const T* __restrict__ g0, const T* __restrict__ g2,
                    const float* __restrict__ p,
                    const float* __restrict__ fq,  // [sites]
                    float* __restrict__ out,       // [4, sites]
                    long long sites, int N) {
    constexpr int W = NGSF_SG_THREADS, TS = W / G, S = NGSF_SG_STAGES;
    constexpr int ESZ = (int)sizeof(T);
    const int tid = threadIdx.x, sub = tid / G, gl = tid % G;
    const long long ntiles = (sites + TS - 1) / TS;

    if constexpr (V == 0) {
        for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
            const long long site = t * TS + sub;
            const bool valid = site < sites;
            const long long base = (valid ? site : 0) * N;
            const T* r0 = g0 + base;
            const T* r2 = g2 + base;
            const float* rp = p + base;
            sg_site<G>(
                [&](int n, float& x0, float& x2, float& F) {
                    x0 = ld_gl(r0 + n);
                    x2 = ld_gl(r2 + n);
                    F = __ldg(rp + n);
                },
                valid, N, gl, valid ? __ldg(fq + site) : 0.0f, out, sites,
                site);
        }
        return;
    }

    extern __shared__ __align__(16) unsigned char smem[];
    const int cells = TS * N;
    const int gb = cells * ESZ;  // a gl slab's bytes a tile
    const int stage = sg_stage_bytes(TS, N, ESZ);
    const long long g_end = sites * N * ESZ, p_end = sites * N * 4;
    const unsigned char* b0 = reinterpret_cast<const unsigned char*>(g0);
    const unsigned char* b2 = reinterpret_cast<const unsigned char*>(g2);
    const unsigned char* bp = reinterpret_cast<const unsigned char*>(p);

    // Stage tile t into stage st. Every tile but the last is whole; bytes
    // of the last one past the slabs' end are zeros.
    auto issue = [&](long long t, int st) {
        unsigned char* d = smem + st * stage;
        const unsigned char* s0 = b0 + t * gb;
        const unsigned char* s2 = b2 + t * gb;
        const unsigned char* sp = bp + t * 4 * cells;
        if (t + 1 < ntiles) {
            for (int c = tid * V; c < gb; c += W * V) {
                sg_copy<V>(d + c, s0 + c, V);
                sg_copy<V>(d + gb + c, s2 + c, V);
            }
            for (int c = tid * V; c < 4 * cells; c += W * V)
                sg_copy<V>(d + 2 * gb + c, sp + c, V);
        } else {
            const int g_left = (int)(g_end - t * gb);
            const int p_left = (int)(p_end - t * 4 * cells);
            for (int c = tid * V; c < gb; c += W * V) {
                const int nb = max(0, min(V, g_left - c));
                sg_copy<V>(d + c, nb ? s0 + c : b0, nb);
                sg_copy<V>(d + gb + c, nb ? s2 + c : b2, nb);
            }
            for (int c = tid * V; c < 4 * cells; c += W * V) {
                const int nb = max(0, min(V, p_left - c));
                sg_copy<V>(d + 2 * gb + c, nb ? sp + c : bp, nb);
            }
        }
        if (tid < TS) {
            const long long s = t * TS + tid;
            cp_async<4>(d + 2 * gb + 4 * cells + 4 * tid,
                        s < sites ? fq + s : fq, s < sites ? 4 : 0);
        }
    };

    const long long first = blockIdx.x, step = gridDim.x;
    const int count =
        first < ntiles ? (int)((ntiles - 1 - first) / step + 1) : 0;
#pragma unroll
    for (int k = 0; k < S - 1; ++k) {
        if (k < count) issue(first + k * step, k);
        cp_async_commit();
    }
    for (int k = 0; k < count; ++k) {
        cp_async_wait<S - 2>();
        __syncthreads();  // tile k landed; tile k - 1 consumed by all
        if (k + S - 1 < count) issue(first + (k + S - 1) * step, (k + S - 1) % S);
        cp_async_commit();
        const unsigned char* d = smem + (k % S) * stage;
        const T* r0 = reinterpret_cast<const T*>(d) + sub * N;
        const T* r2 = reinterpret_cast<const T*>(d + gb) + sub * N;
        const float* rp = reinterpret_cast<const float*>(d + 2 * gb) + sub * N;
        const float f = reinterpret_cast<const float*>(d + 2 * gb + 4 * cells)[sub];
        const long long site = (first + k * step) * TS + sub;
        sg_site<G>(
            [&](int n, float& x0, float& x2, float& F) {
                x0 = to_float(r0[n]);
                x2 = to_float(r2[n]);
                F = rp[n];
            },
            site < sites, N, gl, f, out, sites, site);
    }
    cp_async_wait<0>();
}

template <int G, int V, class T>
static int launch_gv(const T* g0, const T* g2, const float* p,
                     const float* fq, float* out, long long sites, int N,
                     cudaStream_t stream) {
    constexpr int W = NGSF_SG_THREADS, TS = W / G;
    auto kern = k_maf_sums_grad<G, V, T>;
    const long long smem =
        V ? (long long)NGSF_SG_STAGES * sg_stage_bytes(TS, N, sizeof(T)) : 0;
    if (smem > NGSF_SG_SMEM) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, W,
                                                          (size_t)smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long ntiles = (sites + TS - 1) / TS;
    const unsigned grid =
        (unsigned)(ntiles < (long long)per_sm * sms ? ntiles
                                                    : (long long)per_sm * sms);
    if (grid == 0) return 0;
    kern<<<grid, W, (int)smem, stream>>>(g0, g2, p, fq, out, sites, N);
    return (int)cudaGetLastError();
}

// The copy width for the staged geometry: the widest of 16, 8, 4 (and 2
// for bfloat16 gl) bytes that keeps every tile's start aligned in all
// three slabs (their base addresses and a tile's bytes of a gl slab).
template <int G, class T>
static int launch_g(const T* g0, const T* g2, const float* p,
                    const float* fq, float* out, long long sites, int N,
                    bool staged, cudaStream_t s) {
    if (!staged) return launch_gv<G, 0, T>(g0, g2, p, fq, out, sites, N, s);
    const unsigned long long al =
        (unsigned long long)(uintptr_t)g0 | (uintptr_t)g2 | (uintptr_t)p |
        (unsigned long long)(NGSF_SG_THREADS / G) * N * sizeof(T);
    if (al % 16 == 0) return launch_gv<G, 16, T>(g0, g2, p, fq, out, sites, N, s);
    if (al % 8 == 0) return launch_gv<G, 8, T>(g0, g2, p, fq, out, sites, N, s);
    if (al % 4 == 0) return launch_gv<G, 4, T>(g0, g2, p, fq, out, sites, N, s);
    if constexpr (sizeof(T) == 2)
        if (al % 2 == 0)
            return launch_gv<G, 2, T>(g0, g2, p, fq, out, sites, N, s);
    return (int)cudaErrorInvalidValue;
}

// The (G, staged) pairs ops/maf_kernels.py:sums_grad_geometry can choose.
template <class T>
static int launch(const T* g0, const T* g2, const float* p, const float* fq,
                  float* out, long long sites, int N, int G, int staged,
                  void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (G == 8) return launch_g<8, T>(g0, g2, p, fq, out, sites, N, staged, s);
    if (G == 16) return launch_g<16, T>(g0, g2, p, fq, out, sites, N, staged, s);
    if (G == 32) return launch_g<32, T>(g0, g2, p, fq, out, sites, N, staged, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" int ngsf_maf_sums_grad(const float* g0, const float* g2,
                                  const float* p, const float* fq, float* out,
                                  long long sites, int N, int G, int staged,
                                  void* stream) {
    return launch(g0, g2, p, fq, out, sites, N, G, staged, stream);
}

extern "C" int ngsf_maf_sums_grad_bf16(const __nv_bfloat16* g0,
                                       const __nv_bfloat16* g2,
                                       const float* p, const float* fq,
                                       float* out, long long sites, int N,
                                       int G, int staged, void* stream) {
    return launch(g0, g2, p, fq, out, sites, N, G, staged, stream);
}
