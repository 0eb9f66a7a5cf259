// Kernel: per-block transfer products with forward-mode (F, alpha)
// tangents sharing the primal's power-of-two rescale.
// One template over the emission source (hmm_common.cuh), three exports:
//   ngsf_block_transfer_grad     (GlSource) replaces
//                                ngsf_hmm_tpu/models/hmm_pallas.py:_k2_block_transfer_grad
//   ngsf_block_transfer_grad_bf16  the same on bfloat16 gl slabs
//   ngsf_block_transfer_grad_v1  (EmSource) replaces
//                                ngsf_hmm_tpu/models/hmm_pallas.py:_k_block_transfer_grad
//
// What bounds it on the H100 (chip_smoke.py's probes, PERF.md section 7):
// the lane-per-thread design of k_block_transfer (four sites of loads a
// lane, then four sites of arithmetic with nothing in flight) left the
// slabs' loads exposed, and the product-rule tangents cost about twice
// the instructions of the primal step. This design:
//   * stages tiles of NGSF_TG_D sites x the CTA's 128 lanes of both slabs
//     in shared memory with cp.async, NGSF_TG_STAGES tiles deep, so the
//     loads of the next tiles run while the chain works on this one; the
//     per-site freq / dist compacts of the CTA's blocks ride along, and
//     the prior coefficients of site_load are computed once per (site,
//     block) from them (same expressions, same bits);
//   * keeps the primal step of k_block_transfer unchanged and unfused
//     (site_emit, site_matrix, the 2x2 product, pow2_scale at every site,
//     the rescale multiplies; -fmad=false), so the primal rows equal
//     block_transfer's output at B = 1 bit for bit;
//   * factors the tangents: dM/dF has two equal rows, so row r of
//     C dM/dF is (-oe0 s_r, oe1 s_r) with s_r = c_r0 + c_r1, and row r of
//     C dM/dalpha is (de0 w_r, -de1 w_r) with w_r = (1 - F) c_r1 - F c_r0;
//     the tangent updates are explicit __fmaf_rn (FFMA under -fmad=false).
// The plain version (models/hmm_kernels.py:_transfer_grad_loop) runs the
// same tangent order and rounds each multiply-add once, as __fmaf_rn does
// (_fma, through float64), so it gives the kernel's bits; chip_smoke.py
// also holds the tangents to the product rule carried in float64.
#include <cstdint>

#include "hmm_common.cuh"

#define NGSF_TG_THREADS 128  // lanes (threads) a CTA of the exports
#define NGSF_TG_D 8          // sites a tile
#define NGSF_TG_STAGES 3     // tiles in flight
#define NGSF_TG_SM_THREADS 1024  // threads an SM at 64 registers a thread

// The transfer product of one lane with its (F, alpha) tangents. The
// tangent carries lag one rescale behind the primal: the true tangents
// are f * sp and a * sp, sp the last step's power-of-two scale, so each
// step scales the four entries of M (M * sp) instead of the eight tangent
// entries. Power-of-two scalings are exact, so the bits are those of
// rescaling the tangents at every step.
struct GradLane {
    float c00 = 1.0f, c01 = 0.0f, c10 = 0.0f, c11 = 1.0f;
    float f00 = 0.0f, f01 = 0.0f, f10 = 0.0f, f11 = 0.0f;  // d/dF
    float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;  // d/dalpha
    float sp = 1.0f;
    int ex = 0;

    __device__ __forceinline__ void site(const SiteK& k, float F) {
        const float omF = 1.0f - F;
        float m00, m01, m10, m11;
        site_matrix(k, F, m00, m01, m10, m11);
        // primal: the same expressions as k_block_transfer
        const float n00 = c00 * m00 + c01 * m10;
        const float n01 = c00 * m01 + c01 * m11;
        const float n10 = c10 * m00 + c11 * m10;
        const float n11 = c10 * m01 + c11 * m11;
        // tangents of M: dM/dF = onem [[-e0, e1], [-e0, e1]];
        // dM/dalpha = d x [[-F e0, F e1], [(1-F) e0, -(1-F) e1]],
        // with d x forced to 0 at a chromosome break (d = inf, x = 0)
        const float oe0 = k.onem * k.e0;
        const float oe1 = k.onem * k.e1;
        const float dxp = k.x > 0.0f ? k.d * k.x : 0.0f;
        const float de0 = dxp * k.e0;
        const float de1 = dxp * k.e1;
        const float s0 = c00 + c01, s1 = c10 + c11;
        const float w0 = __fmaf_rn(omF, c01, -(F * c00));
        const float w1 = __fmaf_rn(omF, c11, -(F * c10));
        const float q00 = m00 * sp, q01 = m01 * sp;
        const float q10 = m10 * sp, q11 = m11 * sp;
        // d(C M) = dC M + C dM
        const float nf00 = __fmaf_rn(f00, q00, __fmaf_rn(f01, q10, -(oe0 * s0)));
        const float nf01 = __fmaf_rn(f00, q01, __fmaf_rn(f01, q11, oe1 * s0));
        const float nf10 = __fmaf_rn(f10, q00, __fmaf_rn(f11, q10, -(oe0 * s1)));
        const float nf11 = __fmaf_rn(f10, q01, __fmaf_rn(f11, q11, oe1 * s1));
        const float na00 = __fmaf_rn(a00, q00, __fmaf_rn(a01, q10, de0 * w0));
        const float na01 = __fmaf_rn(a00, q01, __fmaf_rn(a01, q11, -(de1 * w0)));
        const float na10 = __fmaf_rn(a10, q00, __fmaf_rn(a11, q10, de0 * w1));
        const float na11 = __fmaf_rn(a10, q01, __fmaf_rn(a11, q11, -(de1 * w1)));
        sp = pow2_scale(fmaxf(max4(n00, n01, n10, n11), NGSF_TINY), ex);
        c00 = n00 * sp; c01 = n01 * sp; c10 = n10 * sp; c11 = n11 * sp;
        f00 = nf00; f01 = nf01; f10 = nf10; f11 = nf11;
        a00 = na00; a01 = na01; a10 = na10; a11 = na11;
    }

    // out [13, nb, N] at this lane
    __device__ __forceinline__ void store(float* o, long long lanes) const {
        o[0] = c00; o[lanes] = c01; o[2 * lanes] = c10; o[3 * lanes] = c11;
        o[4 * lanes] = f00 * sp; o[5 * lanes] = f01 * sp;
        o[6 * lanes] = f10 * sp; o[7 * lanes] = f11 * sp;
        o[8 * lanes] = a00 * sp; o[9 * lanes] = a01 * sp;
        o[10 * lanes] = a10 * sp; o[11 * lanes] = a11 * sp;
        o[12 * lanes] = (float)ex * NGSF_LN2;
    }
};

// cp.async of V bytes (16, 8 or 4) from global to shared memory;
// src_bytes 0 fills the V bytes with zeros and reads nothing.
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (V == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                     "l"(src), "r"(src_bytes));
    else if constexpr (V == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                     "l"(src), "r"(src_bytes));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                     "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <class T>
__device__ __forceinline__ T elem_from_float(float v) {
    return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 elem_from_float<__nv_bfloat16>(
    float v) {
    return __float2bfloat16(v);
}

// Shared memory of one CTA, in bytes, for nbx blocks a CTA at most: the
// slab tiles [S][2 D][NGSF_TG_THREADS], the compacts' entries [S][2][nbx][D]
// (freq, dist), the prior coefficients [nbx][D][2] (float4 each).
template <class Src>
__host__ __device__ constexpr int tg_tile_bytes() {
    return NGSF_TG_STAGES * 2 * NGSF_TG_D * NGSF_TG_THREADS *
           (int)sizeof(typename Src::Elem);
}
__host__ __device__ inline int tg_raw_floats(int nbx) {
    return NGSF_TG_STAGES * 2 * nbx * NGSF_TG_D;  // a multiple of 16
}
template <class Src>
__host__ __device__ inline int tg_smem_bytes(int nbx) {
    return tg_tile_bytes<Src>() + 4 * tg_raw_floats(nbx) +
           (Src::kFreq ? nbx * NGSF_TG_D * 32 : 0);
}

// NGSF_TG_THREADS lanes a CTA; V bytes a copy of the slab rows (16, 8 or
// 4 by cp.async, the widest that keeps every row aligned; 2: one bfloat16
// element by a plain copy, for rows that are not 4-byte aligned). MEM:
// the loads alone (chip_smoke.py's probe): the same staging, each site's
// inputs summed instead of stepped; out[lane] gets the sum.
template <class Src, bool MEM, int V>
__global__ void __launch_bounds__(NGSF_TG_THREADS,
                                  NGSF_TG_SM_THREADS / NGSF_TG_THREADS)
    k_block_transfer_grad(Src src, const float* __restrict__ Fp,
                          const float* __restrict__ ap,
                          float* __restrict__ out, int bs, int nb, int N,
                          int nbx) {
    using T = typename Src::Elem;
    constexpr int D = NGSF_TG_D, S = NGSF_TG_STAGES, W = NGSF_TG_THREADS;
    constexpr int ESZ = (int)sizeof(T);
    constexpr int CPR = W * ESZ / V;      // copies a slab row
    constexpr int RS = W / CPR;           // rows between a thread's copies
    constexpr int NCH = 2 * D / RS;       // copies a thread a tile
    static_assert(V >= ESZ && W % CPR == 0 && (2 * D) % RS == 0, "tile");
    extern __shared__ __align__(16) unsigned char smem[];
    T* tiles = reinterpret_cast<T*>(smem);
    float* raw = reinterpret_cast<float*>(smem + tg_tile_bytes<Src>());
    float4* coef = reinterpret_cast<float4*>(raw + tg_raw_floats(nbx));

    const int tid = threadIdx.x;
    const long long lanes = (long long)nb * N;
    const long long l0 = (long long)blockIdx.x * W;
    const long long lane = l0 + tid;
    const long long lc = lane < lanes ? lane : lanes - 1;
    const int j0 = (int)(l0 / N);
    const int j = (int)(lc / N);
    const int n = (int)(lc - (long long)j * N);
    const int jl = j - j0;
    const int nblk = min(nbx, nb - j0);
    const float F = Fp[n];
    const float a = ap[n];
    const int rb = (bs + NGSF_UNROLL - 1) / NGSF_UNROLL * NGSF_UNROLL;
    const int ntiles = (rb + D - 1) / D;
    // this thread's copies: chunk k of rows row0 + i RS (i < NCH) of a
    // tile, row = h D + u; row0 < RS and RS divides D, so h and
    // u - row0 are compile-time in i. A chunk past the lanes (the last
    // CTA) is zero-filled from a valid address.
    const int k = tid % CPR, row0 = tid / CPR;
    const bool kin = (long long)k * V < (lanes - l0) * ESZ;
    const long long rstride = kin ? lanes * ESZ : 0;  // bytes a site
    const unsigned char* valid = reinterpret_cast<const unsigned char*>(src.a);
    const unsigned char* sbase0 =  // at the next tile to issue
        kin ? reinterpret_cast<const unsigned char*>(src.a + l0) + k * V +
                  row0 * rstride
            : valid;
    const unsigned char* sbase1 =
        kin ? reinterpret_cast<const unsigned char*>(src.b + l0) + k * V +
                  row0 * rstride
            : valid;
    unsigned char* dbase = reinterpret_cast<unsigned char*>(tiles) +
                           row0 * W * ESZ + k * V;

    // Stage tile t (sites t D ..) into stage t % S: the slab rows, and the
    // compacts' entries of the CTA's blocks by 4-byte cp.async; rows at or
    // past bs get the pad values (exact no-ops).
    auto issue = [&](int t) {
        if (t < ntiles) {
            const int st = t % S, r0 = t * D;
            unsigned char* dst0 = dbase + st * 2 * D * W * ESZ;
            auto copy = [&](int i, bool in_bs) {  // copy i of this tile
                const int h = i * RS / D, du = i * RS % D;  // compile-time
                unsigned char* dst = dst0 + (i * RS) * W * ESZ;
                const unsigned char* sp = (h ? sbase1 : sbase0) + du * rstride;
                if (in_bs) {
                    if constexpr (V >= 4) {
                        cp_async<V>(dst, sp, kin ? V : 0);
                    } else {
                        *reinterpret_cast<T*>(dst) =
                            kin ? *reinterpret_cast<const T*>(sp)
                                : elem_from_float<T>(0.0f);
                    }
                } else {
#pragma unroll
                    for (int e = 0; e < V / ESZ; ++e)
                        reinterpret_cast<T*>(dst)[e] =
                            elem_from_float<T>(Src::kPad);
                }
            };
            if (r0 + D <= bs) {  // every row of the tile inside the block
#pragma unroll
                for (int i = 0; i < NCH; ++i) copy(i, true);
            } else {
#pragma unroll
                for (int i = 0; i < NCH; ++i)
                    copy(i, r0 + row0 + i * RS % D < bs);
            }
            sbase0 += D * rstride;  // tiles are issued in order
            sbase1 += D * rstride;
            float* rw = raw + st * 2 * nbx * D;
            for (int c = tid; c < D * nblk; c += W) {
                const int u = c % D, b = c / D, r = r0 + u;
                const long long o = (long long)r * nb + j0 + b;
                if (Src::kFreq) {
                    if (r < bs)
                        cp_async<4>(rw + c, src.fc + o, 4);
                    else
                        rw[c] = 2.0f;
                }
                if (r < bs)
                    cp_async<4>(rw + nbx * D + c, src.dc + o, 4);
                else
                    rw[nbx * D + c] = 0.0f;
            }
        }
        cp_async_commit();
    };

#pragma unroll
    for (int t = 0; t < S - 1; ++t) issue(t);
    GradLane L;
    float acc = 0.0f;
    for (int t = 0; t < ntiles; ++t) {
        cp_async_wait<S - 2>();
        __syncthreads();  // tile t landed; tile t - 1 consumed by all
        issue(t + S - 1);
        const int st = t % S;
        const T* g0t = tiles + st * 2 * D * W + tid;
        const T* g2t = g0t + D * W;
        const float* rw = raw + st * 2 * nbx * D;
        const float* dq = rw + (nbx + jl) * D;  // this lane's block's dist
        if (Src::kFreq && !MEM) {
            for (int e = tid; e < D * nblk; e += W) {
                const Prior q = site_prior(rw[e]);
                coef[2 * e] = make_float4(q.i0, q.pr0, q.pq2, q.pr2);
                coef[2 * e + 1] =
                    make_float4(q.s10, q.het, q.s12, rw[nbx * D + e]);
            }
            __syncthreads();  // the tile's coefficients
        }
        const float4* cq = coef + 2 * D * jl;  // this lane's block's
        auto step = [&](int u) {
            const float g0 = to_float(g0t[u * W]);
            const float g2 = to_float(g2t[u * W]);
            if (MEM) {
                acc += g0 + g2 + dq[u];
            } else if (Src::kFreq) {
                const float4 p = cq[2 * u], s = cq[2 * u + 1];
                const Prior q = {p.x, p.y, p.z, p.w, s.x, s.y, s.z};
                L.site(site_emit(g0, g2, q, s.w, a), F);
            } else {
                L.site(site_em(g0, g2, dq[u], a), F);
            }
        };
        const int nsite = rb - t * D;
        if (nsite >= D) {
#pragma unroll
            for (int u = 0; u < D; ++u) step(u);
        } else {  // the last tile: round_up(bs, NGSF_UNROLL) sites in all
            for (int u = 0; u < nsite; ++u) step(u);
        }
    }
    cp_async_wait<0>();
    if (lane >= lanes) return;
    if (MEM)
        out[lane] = acc;
    else
        L.store(out + lane, lanes);
}

template <class Src, bool MEM = false>
static int launch(Src src, const float* F, const float* alpha, float* out,
                  int bs, int nb, int N, void* stream) {
    constexpr int W = NGSF_TG_THREADS;
    const long long lanes = (long long)nb * N;
    const unsigned grid = (unsigned)((lanes + W - 1) / W);
    const int nbx = min(min((W - 1) / N + 2, W), nb);
    const int smem = tg_smem_bytes<Src>(nbx);
    // the widest copy that keeps every CTA's row segment aligned: the
    // slabs' base addresses (a view may start inside its storage) and the
    // row length; a CTA's segment starts W elements past the last
    const unsigned long long al =
        (unsigned long long)(uintptr_t)src.a | (uintptr_t)src.b |
        (unsigned long long)lanes * sizeof(typename Src::Elem);
    auto go = [&](auto kern) {
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return (int)e;
        }
        kern<<<grid, W, smem, (cudaStream_t)stream>>>(src, F, alpha, out, bs,
                                                      nb, N, nbx);
        return (int)cudaGetLastError();
    };
    if (al % 16 == 0) return go(k_block_transfer_grad<Src, MEM, 16>);
    if (al % 8 == 0) return go(k_block_transfer_grad<Src, MEM, 8>);
    if (al % 4 == 0) return go(k_block_transfer_grad<Src, MEM, 4>);
    if constexpr (sizeof(typename Src::Elem) == 2)
        if (al % 2 == 0) return go(k_block_transfer_grad<Src, MEM, 2>);
    return (int)cudaErrorInvalidValue;
}

extern "C" int ngsf_block_transfer_grad(const float* g0, const float* g2,
                                        const float* fc, const float* dc,
                                        const float* F, const float* alpha,
                                        float* out, int bs, int nb, int N,
                                        void* stream) {
    return launch(GlSource<float>{g0, g2, fc, dc}, F, alpha, out, bs, nb, N,
                  stream);
}

extern "C" int ngsf_block_transfer_grad_bf16(const __nv_bfloat16* g0,
                                             const __nv_bfloat16* g2,
                                             const float* fc, const float* dc,
                                             const float* F,
                                             const float* alpha, float* out,
                                             int bs, int nb, int N,
                                             void* stream) {
    return launch(GlSource<__nv_bfloat16>{g0, g2, fc, dc}, F, alpha, out, bs,
                  nb, N, stream);
}

extern "C" int ngsf_block_transfer_grad_v1(const float* e0, const float* e1,
                                           const float* dc, const float* F,
                                           const float* alpha, float* out,
                                           int bs, int nb, int L,
                                           void* stream) {
    return launch(EmSource{e0, e1, nullptr, dc}, F, alpha, out, bs, nb, L,
                  stream);
}
