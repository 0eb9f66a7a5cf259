// The staging of the tile-fed stream kernels (block_transfer_grad.cu, which
// walks each block's sites forward, and bw_sites.cu, which walks them from
// the block's end): a CTA of NGSF_TG_THREADS (block, column) lanes stages
// tiles of NGSF_TG_D sites x its lanes of both slabs in shared memory with
// cp.async, NGSF_TG_STAGES tiles deep, so the loads of the next tiles run
// while the chain works on this one. The per-site freq / dist compacts'
// entries of the CTA's blocks (at most nbx) ride along, and for the gl
// source the prior coefficients of site_load are computed once per (site,
// block) from them (site_prior: the same expressions, so the same bits).
// Rows outside the block [0, bs) get the pad values (exact no-ops).
#pragma once
#include <cstdint>

#include "cp_async.cuh"
#include "hmm_common.cuh"

#define NGSF_TG_THREADS 128  // lanes (threads) a CTA
#define NGSF_TG_D 8          // sites a tile
#define NGSF_TG_STAGES 3     // tiles in flight

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

// Blocks a CTA's lanes touch at most, for N columns.
__host__ inline int tg_blocks(int N, int nb) {
    return min(min((NGSF_TG_THREADS - 1) / N + 2, NGSF_TG_THREADS), nb);
}

// The widest copy (16, 8 or 4 bytes by cp.async; 2: one bfloat16 element
// by a plain copy) that keeps every CTA's row segment aligned: the slabs'
// base addresses (a view may start inside its storage) and the row length
// (a CTA's segment starts NGSF_TG_THREADS elements past the last); 0 if
// none does.
template <class Src>
__host__ inline int tg_copy_width(const Src& src, long long lanes) {
    const unsigned long long al =
        (unsigned long long)(uintptr_t)src.a | (uintptr_t)src.b |
        (unsigned long long)lanes * sizeof(typename Src::Elem);
    if (al % 16 == 0) return 16;
    if (al % 8 == 0) return 8;
    if (al % 4 == 0) return 4;
    if (sizeof(typename Src::Elem) == 2 && al % 2 == 0) return 2;
    return 0;
}

// One CTA's staging. V bytes a copy of the slab rows. DIR = +1: tiles are
// issued at rows 0, D, 2D, ...; DIR = -1: at rows bs - D, bs - 2D, ...
// (the first may start below 0). Thread tid copies chunk k of rows row0 +
// i RS (i < NCH) of a tile, row = h D + u over the two slabs; row0 < RS
// and RS divides D, so h and u - row0 are compile-time in i. A chunk past
// the lanes (the last CTA) is zero-filled from a valid address.
template <class Src, int V, int DIR>
struct StreamTiles {
    using T = typename Src::Elem;
    static constexpr int D = NGSF_TG_D, S = NGSF_TG_STAGES;
    static constexpr int W = NGSF_TG_THREADS;
    static constexpr int ESZ = (int)sizeof(T);
    static constexpr int CPR = W * ESZ / V;  // copies a slab row
    static constexpr int RS = W / CPR;       // rows between a thread's copies
    static constexpr int NCH = 2 * D / RS;   // copies a thread a tile
    static_assert(V >= ESZ && W % CPR == 0 && (2 * D) % RS == 0, "tile");

    T* tiles;
    float* raw;
    float4* coef;
    const float* fc;
    const float* dc;
    const unsigned char* sbase0;  // at the next tile to issue
    const unsigned char* sbase1;
    unsigned char* dbase;
    long long rstride;  // bytes a site
    int tid, row0, j0, nblk, nbx, bs, nb;
    bool kin;

    // r_first: the first row of the first tile issued
    __device__ __forceinline__ StreamTiles(const Src& src, unsigned char* smem,
                                           long long l0, long long lanes,
                                           int tid_, int bs_, int nb_, int N,
                                           int nbx_, int r_first)
        : tiles(reinterpret_cast<T*>(smem)),
          raw(reinterpret_cast<float*>(smem + tg_tile_bytes<Src>())),
          coef(reinterpret_cast<float4*>(raw + tg_raw_floats(nbx_))),
          fc(src.fc), dc(src.dc), tid(tid_), nbx(nbx_), bs(bs_), nb(nb_) {
        j0 = (int)(l0 / N);
        nblk = min(nbx, nb - j0);
        const int k = tid % CPR;
        row0 = tid / CPR;
        kin = (long long)k * V < (lanes - l0) * ESZ;
        rstride = kin ? lanes * ESZ : 0;
        const unsigned char* valid =
            reinterpret_cast<const unsigned char*>(src.a);
        const long long off = (long long)(r_first + row0) * rstride;
        sbase0 = kin ? reinterpret_cast<const unsigned char*>(src.a + l0) +
                           k * V + off
                     : valid;
        sbase1 = kin ? reinterpret_cast<const unsigned char*>(src.b + l0) +
                           k * V + off
                     : valid;
        dbase = reinterpret_cast<unsigned char*>(tiles) + row0 * W * ESZ +
                k * V;
    }

    // Stage the tile of rows r0 .. r0 + D - 1 into stage st: the slab
    // rows, and the compacts' entries of the CTA's blocks by 4-byte
    // cp.async. Tiles are issued in order (the row pointers advance).
    __device__ __forceinline__ void issue(int st, int r0) {
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
        if ((DIR > 0 || r0 >= 0) && r0 + D <= bs) {  // every row inside
#pragma unroll
            for (int i = 0; i < NCH; ++i) copy(i, true);
        } else {
#pragma unroll
            for (int i = 0; i < NCH; ++i) {
                const int r = r0 + row0 + i * RS % D;
                copy(i, (DIR > 0 || r >= 0) && r < bs);
            }
        }
        sbase0 += DIR * D * rstride;
        sbase1 += DIR * D * rstride;
        float* rw = raw + st * 2 * nbx * D;
        for (int c = tid; c < D * nblk; c += W) {
            const int u = c % D, b = c / D, r = r0 + u;
            const bool in_bs = (DIR > 0 || r >= 0) && r < bs;
            const long long o = (long long)r * nb + j0 + b;
            if (Src::kFreq) {
                if (in_bs)
                    cp_async<4>(rw + c, fc + o, 4);
                else
                    rw[c] = 2.0f;
            }
            if (in_bs)
                cp_async<4>(rw + nbx * D + c, dc + o, 4);
            else
                rw[nbx * D + c] = 0.0f;
        }
    }

    // The compacts' entries of stage st: [2][nbx][D] (freq, dist).
    __device__ __forceinline__ const float* compacts(int st) const {
        return raw + st * 2 * nbx * D;
    }

    // The prior coefficients of stage st's sites for every block of the
    // CTA, each [D][2] float4 (i0, pr0, pq2, pr2), (s10, het, s12, dist);
    // ends with the CTA's barrier. Called by every thread once the stage
    // has landed.
    __device__ __forceinline__ void priors(int st) {
        const float* rw = compacts(st);
        for (int e = tid; e < D * nblk; e += W) {
            const Prior q = site_prior(rw[e]);
            coef[2 * e] = make_float4(q.i0, q.pr0, q.pq2, q.pr2);
            coef[2 * e + 1] =
                make_float4(q.s10, q.het, q.s12, rw[nbx * D + e]);
        }
        __syncthreads();
    }
};
