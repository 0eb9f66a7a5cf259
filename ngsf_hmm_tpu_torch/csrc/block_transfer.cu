// Kernel: per-block transfer products for B candidate parameter sets.
// The primal-only instantiation of the transfer stream (transfer_stream.cuh,
// which holds the design and what bounds it), three exports:
//   ngsf_block_transfer     (GlSource) replaces
//                           ngsf_hmm_tpu/models/hmm_pallas.py:_k2_block_transfer
//   ngsf_block_transfer_bf16  the same on bfloat16 gl slabs
//   ngsf_block_transfer_v1  (EmSource) replaces
//                           ngsf_hmm_tpu/models/hmm_pallas.py:_k_block_transfer
// Bound by bytes: it reads the two slabs once for each group of bc
// candidates (bc = 1 for B = 1, else NGSF_BT_CANDS: models/hmm_kernels.py's
// transfer_candidates) and writes five floats per (candidate, lane).
#include "transfer_stream.cuh"

template <class Src>
static int launch(Src src, const float* F, const float* alpha, float* out,
                  int bs, int nb, int N, int B, int bc, void* stream) {
    if (bc == 1)
        return launch_stream<false, 1>(src, F, alpha, out, bs, nb, N, B,
                                       stream);
    if (bc == NGSF_BT_CANDS)
        return launch_stream<false, NGSF_BT_CANDS>(src, F, alpha, out, bs,
                                                   nb, N, B, stream);
    return (int)cudaErrorInvalidValue;
}

extern "C" int ngsf_block_transfer(const float* g0, const float* g2,
                                   const float* fc, const float* dc,
                                   const float* F, const float* alpha,
                                   float* out, int bs, int nb, int N, int B,
                                   int bc, void* stream) {
    return launch(GlSource<float>{g0, g2, fc, dc}, F, alpha, out, bs, nb, N,
                  B, bc, stream);
}

extern "C" int ngsf_block_transfer_bf16(const __nv_bfloat16* g0,
                                        const __nv_bfloat16* g2,
                                        const float* fc, const float* dc,
                                        const float* F, const float* alpha,
                                        float* out, int bs, int nb, int N,
                                        int B, int bc, void* stream) {
    return launch(GlSource<__nv_bfloat16>{g0, g2, fc, dc}, F, alpha, out, bs,
                  nb, N, B, bc, stream);
}

extern "C" int ngsf_block_transfer_v1(const float* e0, const float* e1,
                                      const float* dc, const float* F,
                                      const float* alpha, float* out, int bs,
                                      int nb, int L, int B, int bc,
                                      void* stream) {
    return launch(EmSource{e0, e1, nullptr, dc}, F, alpha, out, bs, nb, L, B,
                  bc, stream);
}
