// Kernel: Viterbi decode. A group of VT_G = 8 lanes owns one individual.
// Forward pass, eight sites at a time: each lane loads one site's emissions
// and distance and computes its four log-transition entries (the costly
// part: one expf and four logf), then the group walks the eight sites in
// order, every lane running the same two-value carry chain on values
// handed round with warp shuffles. Each site's two back-pointer bits are
// stored by the lane that owns the site. The traceback runs the same way
// over the stored bits, from the last site down.
// Port-only: the JAX package runs this as a lax.scan
// (ngsf_hmm_tpu/models/hmm.py:viterbi); a per-site loop on the host is not
// viable at 10^6 sites.
// Bound by latency: one dependent chain of 2*S steps per individual. Bytes
// moved: the emissions (read once), the back-pointers (written and read)
// and the path (written).
// The arithmetic per site is that of the plain version, in its order, so
// the paths are equal, not merely close.
#include <cuda_runtime.h>
#include <math.h>

#define VT_G 8  // lanes per individual = sites per chunk

template <typename T> struct Pair { T a, b; };

template <typename T>
__global__ void k_viterbi(const T* __restrict__ e_prob,  // [S, N, 2] log
                          const T* __restrict__ dist,    // [S]
                          const T* __restrict__ Fp, const T* __restrict__ ap,
                          const T* __restrict__ init_logits,   // [N, 2] or null
                          const signed char* __restrict__ final_state,  // [N]
                          unsigned char* __restrict__ bp,  // [S, N] scratch
                          signed char* __restrict__ path,  // [S, N]
                          T* __restrict__ score, int S, int N, int compat) {
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int u_me = tid % VT_G;  // this lane's site slot within a chunk
    // groups past N run on individual N - 1 and store nothing, so that
    // every lane of a warp takes part in the shuffles
    const bool live = tid / VT_G < N;
    const int n = live ? tid / VT_G : N - 1;
    const unsigned full = 0xffffffffu;
    const T F = Fp[n], a = ap[n];
    const T q0 = (T)1 - F, q1 = F;
    T v0, v1;
    if (init_logits) {
        v0 = init_logits[2 * n];
        v1 = init_logits[2 * n + 1];
    } else {
        v0 = log(q0);
        v1 = log(q1);
    }
    const Pair<T>* e2 = reinterpret_cast<const Pair<T>*>(e_prob);

    // ---- forward pass; the next chunk's loads are issued a chunk ahead
    Pair<T> e_nx = {(T)0, (T)0};
    T d_nx = (T)0;
    if (u_me < S) {
        e_nx = e2[(long long)u_me * N + n];
        d_nx = dist[u_me];
    }
    for (int s0 = 0; s0 < S; s0 += VT_G) {
        const Pair<T> e = e_nx;
        const T d = d_nx;
        const int s_nx = s0 + VT_G + u_me;
        if (s_nx < S) {
            e_nx = e2[(long long)s_nx * N + n];
            d_nx = dist[s_nx];
        }
        // chromosome break (d = inf): x = 0, the stationary row
        const bool brk = isinf(d);
        const T ds = brk ? (T)1 : d;
        const T x = brk ? (T)0 : exp(-a * ds);
        const T one_m = (T)1 - x;
        const T lt00 = log(one_m * q0 + x);
        const T lt01 = log(one_m * q1);
        const T lt10 = log(one_m * q0);
        const T lt11 = log(one_m * q1 + x);
        int my_bp = 0;
#pragma unroll
        for (int u = 0; u < VT_G; ++u) {
            const T t00 = __shfl_sync(full, lt00, u, VT_G);
            const T t01 = __shfl_sync(full, lt01, u, VT_G);
            const T t10 = __shfl_sync(full, lt10, u, VT_G);
            const T t11 = __shfl_sync(full, lt11, u, VT_G);
            const T e0 = __shfl_sync(full, e.a, u, VT_G);
            const T e1 = __shfl_sync(full, e.b, u, VT_G);
            if (s0 + u < S) {
                const T a0 = v0 + t00, b0 = v1 + t10;
                const int bp0 = b0 > a0;  // strict >: ties keep k = 0
                const T n0 = fmax(a0, b0) + e0;
                // compat: state 1's k = 0 candidate uses the already
                // updated n0 (the reference's in-place update)
                const T a1 = (compat ? n0 : v0) + t01, b1 = v1 + t11;
                const int bp1 = b1 > a1;
                const T n1 = fmax(a1, b1) + e1;
                if (u == u_me) my_bp = bp0 | (bp1 << 1);
                v0 = n0;
                v1 = n1;
            }
        }
        if (live && s0 + u_me < S)
            bp[(long long)(s0 + u_me) * N + n] = (unsigned char)my_bp;
    }
    int cur = final_state ? (int)final_state[n] : (int)(v1 > v0);
    if (live && u_me == 0) score[n] = cur == 1 ? v1 : v0;

    // ---- traceback: path[s] = cur, then cur = bp[s][cur], chunks from the
    // end. The chunks are cut as above, so a lane reads back only the bits
    // it stored itself.
    const int last0 = ((S - 1) / VT_G) * VT_G;
    int b_nx = 0;
    if (last0 + u_me < S) b_nx = bp[(long long)(last0 + u_me) * N + n];
    for (int s0 = last0; s0 >= 0; s0 -= VT_G) {
        const int b = b_nx;
        if (s0 >= VT_G) b_nx = bp[(long long)(s0 - VT_G + u_me) * N + n];
        int my_path = 0;
#pragma unroll
        for (int u = VT_G - 1; u >= 0; --u) {
            const int bu = __shfl_sync(full, b, u, VT_G);
            if (s0 + u < S) {
                if (u == u_me) my_path = cur;
                if (s0 + u > 0) cur = (bu >> cur) & 1;
            }
        }
        if (live && s0 + u_me < S)
            path[(long long)(s0 + u_me) * N + n] = (signed char)my_path;
    }
}

template <typename T>
static int launch(const void* e_prob, const void* dist, const void* F,
                  const void* alpha, const void* init_logits,
                  const void* final_state, void* bp, void* path, void* score,
                  int S, int N, int compat, void* stream) {
    // whole warps only: every lane takes part in the shuffles
    const int threads = 16 * VT_G;
    const unsigned grid = (unsigned)((N * VT_G + threads - 1) / threads);
    k_viterbi<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const T*)e_prob, (const T*)dist, (const T*)F, (const T*)alpha,
        (const T*)init_logits, (const signed char*)final_state,
        (unsigned char*)bp, (signed char*)path, (T*)score, S, N, compat);
    return (int)cudaGetLastError();
}

extern "C" int ngsf_viterbi_f32(const void* e_prob, const void* dist,
                                const void* F, const void* alpha,
                                const void* init_logits,
                                const void* final_state, void* bp, void* path,
                                void* score, int S, int N, int compat,
                                void* stream) {
    return launch<float>(e_prob, dist, F, alpha, init_logits, final_state, bp,
                         path, score, S, N, compat, stream);
}

extern "C" int ngsf_viterbi_f64(const void* e_prob, const void* dist,
                                const void* F, const void* alpha,
                                const void* init_logits,
                                const void* final_state, void* bp, void* path,
                                void* score, int S, int N, int compat,
                                void* stream) {
    return launch<double>(e_prob, dist, F, alpha, init_logits, final_state, bp,
                          path, score, S, N, compat, stream);
}
