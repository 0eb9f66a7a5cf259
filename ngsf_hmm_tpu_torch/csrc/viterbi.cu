// Kernel: Viterbi decode, in four launches.
//
// 1. Forward (k_vt_forward): one CTA per group of G individuals (G a power
//    of two from 1 to 32, the least that keeps to one CTA an SM). Warp 0
//    runs the chains, one lane per individual, over the sites in the plain
//    version's order, so scores and back-pointers equal it bit for bit.
//    The other VT_PW warps are producers: for the next tile of sites they
//    copy the emissions into shared memory with cp.async and compute the
//    four log-transitions of each (site, individual) there (one exp, four
//    log: the costly part). Two tiles alternate, one __syncthreads between
//    them. A chain lane then does only its dependent adds, compares and
//    maxes per site, on inputs it loads from shared memory into registers
//    a group of sites ahead of use, and packs the two back-pointer bits of
//    16 sites into one word.
// 2. Block maps (k_vt_maps): the traceback step cur <- bp[s][cur] is a map
//    {0,1} -> {0,1}, and maps compose exactly. One thread per (traceback
//    block of L sites, individual) composes its block's maps into one.
// 3. Exit walk (k_vt_walk): one thread per individual walks the S / L
//    block maps backwards from the final state, 16 a load, giving each
//    block's state at its last site.
// 4. Decode (k_vt_decode): one thread per (block, individual) writes its
//    block's path from that exit state, path[s] = cur before each step,
//    no step at s = 0 (as the plain version).
//
// Port-only: the JAX package runs Viterbi as a lax.scan
// (ngsf_hmm_tpu/models/hmm.py:viterbi). What bounds it on this card is
// the latency of the S-step chain of each individual (a max-plus scan over
// sites would re-associate float sums of size 1e5-1e6 and change the
// path): six dependent float operations a site under the in-place
// (compat) update, three in the textbook variant. The design keeps
// everything else off that chain: the transcendentals and loads run in
// the producer warps a tile ahead, and the traceback, serial in the plain
// order, becomes an exact parallel pass. Bytes moved: the emissions (read
// once), the packed back-pointers (S * N / 4, written and read) and the
// path (written).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#define VT_PW 7       // producer warps
#define VT_THREADS ((1 + VT_PW) * 32)
#define VT_ID 2u      // the identity map: f(0) = 0, f(1) = 1

template <typename T> struct alignas(2 * sizeof(T)) Pair { T a, b; };
template <typename T> struct alignas(4 * sizeof(T)) Quad { T t00, t01, t10, t11; };

// (site, individual) cells per tile: a stage is 48 KB for either type
template <typename T> struct Stage { static constexpr int kCells = 8192 / sizeof(T); };

template <typename T>
constexpr size_t vt_smem() {
    return 2 * (size_t)Stage<T>::kCells * (sizeof(Quad<T>) + sizeof(Pair<T>));
}

// m o g as maps on {0, 1}, each coded f(0) | f(1) << 1
__device__ __forceinline__ unsigned vt_compose(unsigned m, unsigned g) {
    return ((m >> (g & 1u)) & 1u) | (((m >> ((g >> 1) & 1u)) & 1u) << 1);
}

// One site of the chain; its two back-pointer bits go to w at bit 2 u
// (set under a predicate: two instructions a bit, off the chain).
template <typename T, bool COMPAT>
__device__ __forceinline__ void vt_site(const Quad<T>& lt, const Pair<T>& em,
                                        int u, T& v0, T& v1, unsigned& w) {
    const T a0 = v0 + lt.t00, b0 = v1 + lt.t10;
    const T m0 = fmax(a0, b0) + em.a;
    // compat: state 1's k = 0 candidate uses the already updated m0 (the
    // reference's in-place update)
    const T a1 = (COMPAT ? m0 : v0) + lt.t01, b1 = v1 + lt.t11;
    const T m1 = fmax(a1, b1) + em.b;
    if (b0 > a0) w |= 1u << (2 * u);  // strict >: ties keep k = 0
    if (b1 > a1) w |= 2u << (2 * u);
    v0 = m0;
    v1 = m1;
}

// The chain lane's inputs for PRE sites, read from the shared stage.
template <typename T, int G, int PRE>
__device__ __forceinline__ void vt_load(Quad<T> (&lt)[PRE], Pair<T> (&em)[PRE],
                                        const Quad<T>* q, const Pair<T>* e,
                                        int t0) {
#pragma unroll
    for (int u = 0; u < PRE; ++u) {
        lt[u] = q[(t0 + u) * G];
        em[u] = e[(t0 + u) * G];
    }
}

// One CTA an SM: the chain lane may hold two groups of inputs in registers.
template <typename T, bool COMPAT, int G>
__global__ void __launch_bounds__(VT_THREADS, 1)
k_vt_forward(const T* __restrict__ e_prob,  // [S, N, 2] log
             const T* __restrict__ dist,    // [S]
             const T* __restrict__ Fp, const T* __restrict__ ap,
             const T* __restrict__ init_logits,           // [N, 2] or null
             const signed char* __restrict__ final_state,  // [N] or null
             unsigned* __restrict__ bpk,    // [ceil(S / 16), N] packed bits
             signed char* __restrict__ path,  // [S, N]: row S - 1 only
             T* __restrict__ score, int S, int N) {
    constexpr int TS = Stage<T>::kCells / G;  // sites per tile
    constexpr int PRE = 64 / sizeof(T);  // sites a group: 16 / 8
    static_assert(TS % 16 == 0 && (2 * PRE) % 16 == 0, "whole words");
    extern __shared__ __align__(32) unsigned char vt_sm[];
    Quad<T>* sq = reinterpret_cast<Quad<T>*>(vt_sm);       // [2][TS][G]
    Pair<T>* se = reinterpret_cast<Pair<T>*>(sq + 2 * TS * G);
    const Pair<T>* e2 = reinterpret_cast<const Pair<T>*>(e_prob);
    const int n0 = blockIdx.x * G;
    const int g_live = min(G, N - n0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int ntiles = (S + TS - 1) / TS;

    // a producer thread keeps one individual: its stride over the tile's
    // cells (VT_PW * 32) is a multiple of G
    const int pid = threadIdx.x - 32;
    const int pg = pid & (G - 1);
    const bool p_live = warp > 0 && pg < g_live;
    T pa = (T)0, pq0 = (T)0, pq1 = (T)0;
    if (p_live) {
        pa = ap[n0 + pg];
        pq1 = Fp[n0 + pg];
        pq0 = (T)1 - pq1;
    }
    auto produce = [&](int tile) {
        const int s0 = tile * TS, buf = tile & 1;
        Quad<T>* q = sq + buf * TS * G;
        Pair<T>* e = se + buf * TS * G;
        if (p_live) {
#pragma unroll 3
            for (int idx = pid; idx < TS * G; idx += VT_PW * 32) {
                const int s = s0 + idx / G;
                if (s < S) {
                    __pipeline_memcpy_async(
                        &e[idx], &e2[(long long)s * N + n0 + pg],
                        sizeof(Pair<T>));
                    // chromosome break (d = inf): x = 0, the stationary row
                    const T d = dist[s];
                    const bool brk = isinf(d);
                    const T ds = brk ? (T)1 : d;
                    const T x = brk ? (T)0 : exp(-pa * ds);
                    const T one_m = (T)1 - x;
                    Quad<T> lt;
                    lt.t00 = log(one_m * pq0 + x);
                    lt.t01 = log(one_m * pq1);
                    lt.t10 = log(one_m * pq0);
                    lt.t11 = log(one_m * pq1 + x);
                    q[idx] = lt;
                }
            }
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
    };

    // chain lane state
    const bool c_live = warp == 0 && lane < g_live;
    const int n = n0 + (c_live ? lane : 0);
    T v0 = (T)0, v1 = (T)0;
    if (c_live) {
        if (init_logits) {
            v0 = init_logits[2 * n];
            v1 = init_logits[2 * n + 1];
        } else {
            const T F = Fp[n];
            v0 = log((T)1 - F);
            v1 = log(F);
        }
    }

    if (warp > 0) produce(0);
    __syncthreads();
    for (int tile = 0; tile < ntiles; ++tile) {
        if (warp > 0) {
            if (tile + 1 < ntiles) produce(tile + 1);
        } else if (c_live) {
            const int s0 = tile * TS, buf = tile & 1;
            const Quad<T>* q = sq + buf * TS * G + lane;
            const Pair<T>* e = se + buf * TS * G + lane;
            const int nt = min(TS, S - s0);
            // Groups A and B of PRE sites in turn: the loads of one group
            // are issued before the other group's chain steps, so that
            // their latency passes under those steps. Bits at (site & 15).
            const int npipe = nt - nt % (2 * PRE);
            Quad<T> la[PRE], lb[PRE];
            Pair<T> ea[PRE], eb[PRE];
            unsigned w = 0;
            if (npipe > 0) vt_load<T, G, PRE>(la, ea, q, e, 0);
#pragma unroll 1
            for (int t0 = 0; t0 < npipe; t0 += 2 * PRE) {
                vt_load<T, G, PRE>(lb, eb, q, e, t0 + PRE);
#pragma unroll
                for (int u = 0; u < PRE; ++u)
                    vt_site<T, COMPAT>(la[u], ea[u], u, v0, v1, w);
                if (PRE == 16) {
                    bpk[(long long)((s0 + t0) >> 4) * N + n] = w;
                    w = 0;
                }
                if (t0 + 2 * PRE < npipe)
                    vt_load<T, G, PRE>(la, ea, q, e, t0 + 2 * PRE);
#pragma unroll
                for (int u = 0; u < PRE; ++u)
                    vt_site<T, COMPAT>(lb[u], eb[u], (PRE & 15) + u, v0, v1,
                                       w);
                bpk[(long long)((s0 + t0 + PRE) >> 4) * N + n] = w;
                w = 0;
            }
            // the tile's last sites (fewer than 2 * PRE), a word at a time
            for (int t0 = npipe; t0 < nt; t0 += 16) {
                w = 0;
                for (int u = 0; u < min(16, nt - t0); ++u)
                    vt_site<T, COMPAT>(q[(t0 + u) * G], e[(t0 + u) * G], u,
                                       v0, v1, w);
                bpk[(long long)((s0 + t0) >> 4) * N + n] = w;
            }
        }
        __syncthreads();
    }
    if (c_live) {
        const int cur = final_state ? (int)final_state[n] : (int)(v1 > v0);
        score[n] = cur == 1 ? v1 : v0;
        path[(long long)(S - 1) * N + n] = (signed char)cur;
    }
}

__device__ __forceinline__ unsigned vt_bits(const unsigned* __restrict__ bpk,
                                            int s, int N, int n) {
    return (bpk[(long long)(s >> 4) * N + n] >> (2 * (s & 15))) & 3u;
}

// block k's map f_k = g_{kL} o ... o g_{end}: the state at site kL - 1
// from the state at the block's last site; the pad entries past the last
// block (k < nbp) are the identity
__global__ void k_vt_maps(const unsigned* __restrict__ bpk,
                          unsigned char* __restrict__ maps, int S, int N,
                          int L, int nbp) {
    const int n = blockIdx.y * blockDim.x + threadIdx.x;
    const int k = blockIdx.x * blockDim.y + threadIdx.y;
    if (n >= N || k >= nbp) return;
    const long long s0 = (long long)k * L;
    const int s1 = s0 + L < S ? (int)(s0 + L) : S;
    unsigned m = VT_ID;
    for (int s = (int)s0; s < s1; ++s) m = vt_compose(m, vt_bits(bpk, s, N, n));
    maps[(long long)n * nbp + k] = (unsigned char)m;
}

// One thread per individual: each block's map is replaced by the block's
// exit state (the state at its last site). The maps of a row come 16 a
// load (nbp is a multiple of 16), the next load issued before the current
// 16 steps.
__global__ void k_vt_walk(unsigned char* __restrict__ maps,
                          const signed char* __restrict__ path, int S, int N,
                          int nbp) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    unsigned cur = (unsigned)path[(long long)(S - 1) * N + n];
    uint4* row = reinterpret_cast<uint4*>(maps + (long long)n * nbp);
    int g = nbp / 16 - 1;
    uint4 nxt = row[g];
    for (; g >= 0; --g) {
        const unsigned m4[4] = {nxt.x, nxt.y, nxt.z, nxt.w};
        if (g > 0) nxt = row[g - 1];
        unsigned o4[4];
#pragma unroll
        for (int i = 3; i >= 0; --i) {
            unsigned o = 0;
#pragma unroll
            for (int b = 3; b >= 0; --b) {
                o |= cur << (8 * b);
                cur = (m4[i] >> (8 * b + cur)) & 1u;
            }
            o4[i] = o;
        }
        row[g] = make_uint4(o4[0], o4[1], o4[2], o4[3]);
    }
}

__global__ void k_vt_decode(const unsigned* __restrict__ bpk,
                            const unsigned char* __restrict__ exits,
                            signed char* __restrict__ path, int S, int N,
                            int L, int nbp) {
    const int n = blockIdx.y * blockDim.x + threadIdx.x;
    const int k = blockIdx.x * blockDim.y + threadIdx.y;
    const long long s0 = (long long)k * L;
    if (n >= N || s0 >= S) return;
    unsigned cur = exits[(long long)n * nbp + k];
    const int s1 = s0 + L < S ? (int)(s0 + L) : S;
    for (int s = s1 - 1; s >= (int)s0; --s) {
        path[(long long)s * N + n] = (signed char)cur;
        if (s > 0) cur = (vt_bits(bpk, s, N, n) >> cur) & 1u;
    }
}

template <typename T, bool COMPAT, int G>
static int launch_forward(const void* e_prob, const void* dist, const void* F,
                          const void* alpha, const void* init_logits,
                          const void* final_state, void* bpk, void* path,
                          void* score, int S, int N, cudaStream_t st) {
    constexpr size_t smem = vt_smem<T>();
    auto fwd = k_vt_forward<T, COMPAT, G>;
    int rc = (int)cudaFuncSetAttribute(
        fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
    fwd<<<(N + G - 1) / G, VT_THREADS, smem, st>>>(
        (const T*)e_prob, (const T*)dist, (const T*)F, (const T*)alpha,
        (const T*)init_logits, (const signed char*)final_state,
        (unsigned*)bpk, (signed char*)path, (T*)score, S, N);
    return (int)cudaGetLastError();
}

template <typename T, bool COMPAT>
static int forward_g(int G, const void* e, const void* d, const void* F,
                     const void* a, const void* il, const void* fs, void* bpk,
                     void* path, void* score, int S, int N, cudaStream_t st) {
#define VT_CASE(g)                                                         \
    case g:                                                                \
        return launch_forward<T, COMPAT, g>(e, d, F, a, il, fs, bpk, path, \
                                            score, S, N, st);
    switch (G) {
        VT_CASE(1) VT_CASE(2) VT_CASE(4) VT_CASE(8) VT_CASE(16) VT_CASE(32)
    }
#undef VT_CASE
    return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch(const void* e_prob, const void* dist, const void* F,
                  const void* alpha, const void* init_logits,
                  const void* final_state, void* bpk, void* maps, void* path,
                  void* score, int S, int N, int compat, int L,
                  void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (S < 1 || N < 1 || L < 1) return (int)cudaErrorInvalidValue;
    // individuals per CTA: the fewest that keep to one CTA an SM (the
    // chain lane's registers leave room for one)
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int G = 1;
    while (G < 32 && (N + G - 1) / G > sms) G *= 2;
    int rc = compat ? forward_g<T, true>(G, e_prob, dist, F, alpha,
                                         init_logits, final_state, bpk, path,
                                         score, S, N, st)
                    : forward_g<T, false>(G, e_prob, dist, F, alpha,
                                          init_logits, final_state, bpk, path,
                                          score, S, N, st);
    if (rc) return rc;
    const int nblk = (S + L - 1) / L;
    const int nbp = (nblk + 15) & ~15;
    // threads: 32 individuals x 8 traceback blocks
    const dim3 tb(32, 8), gm((nbp + 7) / 8, (N + 31) / 32),
        gd((nblk + 7) / 8, (N + 31) / 32);
    k_vt_maps<<<gm, tb, 0, st>>>((const unsigned*)bpk, (unsigned char*)maps,
                                 S, N, L, nbp);
    if ((rc = (int)cudaGetLastError())) return rc;
    k_vt_walk<<<(N + 127) / 128, 128, 0, st>>>(
        (unsigned char*)maps, (const signed char*)path, S, N, nbp);
    if ((rc = (int)cudaGetLastError())) return rc;
    k_vt_decode<<<gd, tb, 0, st>>>((const unsigned*)bpk,
                                   (const unsigned char*)maps,
                                   (signed char*)path, S, N, L, nbp);
    return (int)cudaGetLastError();
}

// bpk: [ceil(S / 16), N] uint32 scratch; maps: [N, nbp] uint8 scratch with
// nbp = ceil(ceil(S / L) / 16) * 16, rows 16-byte aligned
extern "C" int ngsf_viterbi_f32(const void* e_prob, const void* dist,
                                const void* F, const void* alpha,
                                const void* init_logits,
                                const void* final_state, void* bpk,
                                void* maps, void* path, void* score, int S,
                                int N, int compat, int L, void* stream) {
    return launch<float>(e_prob, dist, F, alpha, init_logits, final_state,
                         bpk, maps, path, score, S, N, compat, L, stream);
}

extern "C" int ngsf_viterbi_f64(const void* e_prob, const void* dist,
                                const void* F, const void* alpha,
                                const void* init_logits,
                                const void* final_state, void* bpk,
                                void* maps, void* path, void* score, int S,
                                int N, int compat, int L, void* stream) {
    return launch<double>(e_prob, dist, F, alpha, init_logits, final_state,
                          bpk, maps, path, score, S, N, compat, L, stream);
}
