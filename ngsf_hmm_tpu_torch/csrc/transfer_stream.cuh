// The forward transfer stream of the gl and emission slabs: per-block
// transfer products, with or without forward-mode (F, alpha) tangents.
// One kernel template for both, so that the primal step has one source:
//   block_transfer_grad.cu  TANG = true, one candidate (rows 1 and 12);
//   block_transfer.cu       TANG = false, B candidates (rows 4 and 10).
//
// What bounds it on the H100 (chip_smoke.py's probes, PERF.md section 7):
// a lane-per-thread design (four sites of loads a lane in the lane order,
// then four sites of arithmetic with nothing in flight) leaves the slabs'
// loads exposed, and the product-rule tangents cost about twice the
// instructions of the primal step. This design:
//   * stages tiles of NGSF_TG_D sites x the CTA's 128 lanes of both slabs
//     in shared memory with cp.async, NGSF_TG_STAGES tiles deep
//     (stream_tiles.cuh, shared with bw_sites.cu), so the loads of the
//     next tiles run while the chain works on this one; the per-site freq
//     / dist compacts of the CTA's blocks ride along, and the prior
//     coefficients of site_load are computed once per (site, block) from
//     them (same expressions, same bits);
//   * runs every candidate a CTA takes (at most NGSF_BT_CANDS; a grid row
//     a group of them) from the one staged tile, each with its carries and
//     exponent in registers, so the slabs are read once per group and not
//     once per candidate;
//   * keeps the primal step unfused (site_emit, site_matrix, the 2x2
//     product, pow2_scale at every site, the rescale multiplies;
//     -fmad=false); the tangents add to it and change none of its
//     operands, so the grad kernel's primal rows equal the transfer
//     kernel's output at B = 1 bit for bit by construction;
//   * factors the tangents: dM/dF has two equal rows, so row r of
//     C dM/dF is (-oe0 s_r, oe1 s_r) with s_r = c_r0 + c_r1, and row r of
//     C dM/dalpha is (de0 w_r, -de1 w_r) with w_r = (1 - F) c_r1 - F c_r0;
//     the tangent updates are explicit __fmaf_rn (FFMA under -fmad=false).
// The plain versions (models/hmm_kernels.py:_transfer_loop,
// _transfer_grad_loop) run the same order; the latter rounds each tangent
// multiply-add once, as __fmaf_rn does (_fma, through float64), so both
// give the kernels' bits.
#pragma once
#include "stream_tiles.cuh"

#define NGSF_TG_SM_THREADS 1024  // threads an SM at 64 registers a thread
#define NGSF_BT_CANDS 2  // candidates a CTA of the transfer kernel takes

// The transfer product of one lane, with its (F, alpha) tangents if TANG.
// The tangent carries lag one rescale behind the primal: the true tangents
// are f * sp and a * sp, sp the last step's power-of-two scale, so each
// step scales the four entries of M (M * sp) instead of the eight tangent
// entries. Power-of-two scalings are exact, so the bits are those of
// rescaling the tangents at every step.
template <bool TANG>
struct TransferLane {
    float c00 = 1.0f, c01 = 0.0f, c10 = 0.0f, c11 = 1.0f;
    float f00 = 0.0f, f01 = 0.0f, f10 = 0.0f, f11 = 0.0f;  // d/dF
    float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;  // d/dalpha
    float sp = 1.0f;
    int ex = 0;

    __device__ __forceinline__ void site(const SiteK& k, float F) {
        float m00, m01, m10, m11;
        site_matrix(k, F, m00, m01, m10, m11);
        const float n00 = c00 * m00 + c01 * m10;
        const float n01 = c00 * m01 + c01 * m11;
        const float n10 = c10 * m00 + c11 * m10;
        const float n11 = c10 * m01 + c11 * m11;
        if constexpr (TANG) tangents(k, F, m00, m01, m10, m11);
        sp = pow2_scale(fmaxf(max4(n00, n01, n10, n11), NGSF_TINY), ex);
        c00 = n00 * sp; c01 = n01 * sp; c10 = n10 * sp; c11 = n11 * sp;
    }

    // d(C M) = dC M + C dM from the carries before this site's product.
    // dM/dF = onem [[-e0, e1], [-e0, e1]]; dM/dalpha = d x [[-F e0, F e1],
    // [(1-F) e0, -(1-F) e1]], with d x forced to 0 at a chromosome break
    // (d = inf, x = 0).
    __device__ __forceinline__ void tangents(const SiteK& k, float F,
                                             float m00, float m01, float m10,
                                             float m11) {
        const float omF = 1.0f - F;
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
        const float nf00 = __fmaf_rn(f00, q00, __fmaf_rn(f01, q10, -(oe0 * s0)));
        const float nf01 = __fmaf_rn(f00, q01, __fmaf_rn(f01, q11, oe1 * s0));
        const float nf10 = __fmaf_rn(f10, q00, __fmaf_rn(f11, q10, -(oe0 * s1)));
        const float nf11 = __fmaf_rn(f10, q01, __fmaf_rn(f11, q11, oe1 * s1));
        const float na00 = __fmaf_rn(a00, q00, __fmaf_rn(a01, q10, de0 * w0));
        const float na01 = __fmaf_rn(a00, q01, __fmaf_rn(a01, q11, -(de1 * w0)));
        const float na10 = __fmaf_rn(a10, q00, __fmaf_rn(a11, q10, de0 * w1));
        const float na11 = __fmaf_rn(a10, q01, __fmaf_rn(a11, q11, -(de1 * w1)));
        f00 = nf00; f01 = nf01; f10 = nf10; f11 = nf11;
        a00 = na00; a01 = na01; a10 = na10; a11 = na11;
    }

    // TANG: out [13, nb, N] at this lane (plane = nb N): primal (4), d/dF
    // (4), d/dalpha (4), log-offset. Else out [5, B, nb, N] at this
    // (candidate, lane) (plane = B nb N): primal (4), log-offset.
    __device__ __forceinline__ void store(float* o, long long plane) const {
        o[0] = c00; o[plane] = c01; o[2 * plane] = c10; o[3 * plane] = c11;
        if constexpr (TANG) {
            o[4 * plane] = f00 * sp; o[5 * plane] = f01 * sp;
            o[6 * plane] = f10 * sp; o[7 * plane] = f11 * sp;
            o[8 * plane] = a00 * sp; o[9 * plane] = a01 * sp;
            o[10 * plane] = a10 * sp; o[11 * plane] = a11 * sp;
            o[12 * plane] = (float)ex * NGSF_LN2;
        } else {
            o[4 * plane] = (float)ex * NGSF_LN2;
        }
    }
};

// NGSF_TG_THREADS lanes a CTA; V bytes a copy of the slab rows (16, 8 or
// 4 by cp.async, the widest that keeps every row aligned; 2: one bfloat16
// element by a plain copy, for rows that are not 4-byte aligned). BC
// candidates a CTA: grid row y takes candidates y BC .. y BC + BC - 1 of
// B, a ragged last group repeating candidate B - 1 without storing it
// (TANG: one candidate, B = 1 at compile time). MEM: the loads alone
// (chip_smoke.py's probe): the same staging, each site's inputs summed
// instead of stepped; out[lane] gets the sum.
template <class Src, bool MEM, int V, bool TANG, int BC>
__global__ void __launch_bounds__(NGSF_TG_THREADS,
                                  NGSF_TG_SM_THREADS / NGSF_TG_THREADS)
    k_transfer_stream(Src src, const float* __restrict__ Fp,
                      const float* __restrict__ ap, float* __restrict__ out,
                      int bs, int nb, int N, int nbx, int B_) {
    static_assert(!TANG || BC == 1, "the tangent stream takes one candidate");
    const int B = TANG ? 1 : B_;
    using T = typename Src::Elem;
    constexpr int D = NGSF_TG_D, S = NGSF_TG_STAGES, W = NGSF_TG_THREADS;
    extern __shared__ __align__(16) unsigned char smem[];

    const int tid = threadIdx.x;
    const long long lanes = (long long)nb * N;
    const long long l0 = (long long)blockIdx.x * W;
    const long long lane = l0 + tid;
    const long long lc = lane < lanes ? lane : lanes - 1;
    const int j = (int)(lc / N);
    const int n = (int)(lc - (long long)j * N);
    const int b0 = TANG ? 0 : (int)blockIdx.y * BC;
    float F[BC], a[BC];
#pragma unroll
    for (int c = 0; c < BC; ++c) {
        const long long o = (long long)min(b0 + c, B - 1) * N + n;
        F[c] = Fp[o];
        a[c] = ap[o];
    }
    const int rb = (bs + NGSF_UNROLL - 1) / NGSF_UNROLL * NGSF_UNROLL;
    const int ntiles = (rb + D - 1) / D;
    StreamTiles<Src, V, 1> tl(src, smem, l0, lanes, tid, bs, nb, N, nbx, 0);
    const int jl = j - tl.j0;
    auto issue = [&](int t) {  // tile t: sites t D ..
        if (t < ntiles) tl.issue(t % S, t * D);
        cp_async_commit();
    };

#pragma unroll
    for (int t = 0; t < S - 1; ++t) issue(t);
    TransferLane<TANG> L[BC];
    float acc = 0.0f;
    for (int t = 0; t < ntiles; ++t) {
        cp_async_wait<S - 2>();
        __syncthreads();  // tile t landed; tile t - 1 consumed by all
        issue(t + S - 1);
        const int st = t % S;
        const T* g0t = tl.tiles + st * 2 * D * W + tid;
        const T* g2t = g0t + D * W;
        const float* dq = tl.compacts(st) + (nbx + jl) * D;  // lane's dist
        if (Src::kFreq && !MEM) tl.priors(st);  // the tile's coefficients
        const float4* cq = tl.coef + 2 * D * jl;  // this lane's block's
        auto step = [&](int u) {
            const float g0 = to_float(g0t[u * W]);
            const float g2 = to_float(g2t[u * W]);
            if (MEM) {
                acc += g0 + g2 + dq[u];
            } else if (Src::kFreq) {
                const float4 p = cq[2 * u], s = cq[2 * u + 1];
                const Prior q = {p.x, p.y, p.z, p.w, s.x, s.y, s.z};
#pragma unroll
                for (int c = 0; c < BC; ++c)
                    L[c].site(site_emit(g0, g2, q, s.w, a[c]), F[c]);
            } else {
#pragma unroll
                for (int c = 0; c < BC; ++c)
                    L[c].site(site_em(g0, g2, dq[u], a[c]), F[c]);
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
    if (MEM) {
        out[lane] = acc;
        return;
    }
#pragma unroll
    for (int c = 0; c < BC; ++c)
        if (b0 + c < B)
            L[c].store(out + (long long)(b0 + c) * lanes + lane,
                       (long long)B * lanes);
}

// Launches the stream for B candidates, BC a CTA, on the copy width the
// slabs allow; returns the CUDA error (cudaErrorInvalidValue where no
// width does).
template <bool TANG, int BC, bool MEM = false, class Src>
static int launch_stream(Src src, const float* F, const float* alpha,
                         float* out, int bs, int nb, int N, int B,
                         void* stream) {
    constexpr int W = NGSF_TG_THREADS;
    const long long lanes = (long long)nb * N;
    const dim3 grid((unsigned)((lanes + W - 1) / W),
                    (unsigned)((B + BC - 1) / BC));
    const int nbx = tg_blocks(N, nb);
    const int smem = tg_smem_bytes<Src>(nbx);
    auto go = [&](auto kern) {
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return (int)e;
        }
        kern<<<grid, W, smem, (cudaStream_t)stream>>>(src, F, alpha, out, bs,
                                                      nb, N, nbx, B);
        return (int)cudaGetLastError();
    };
    switch (tg_copy_width(src, lanes)) {
    case 16: return go(k_transfer_stream<Src, MEM, 16, TANG, BC>);
    case 8: return go(k_transfer_stream<Src, MEM, 8, TANG, BC>);
    case 4: return go(k_transfer_stream<Src, MEM, 4, TANG, BC>);
    case 2:
        if constexpr (sizeof(typename Src::Elem) == 2)
            return go(k_transfer_stream<Src, MEM, 2, TANG, BC>);
    }
    return (int)cudaErrorInvalidValue;
}
