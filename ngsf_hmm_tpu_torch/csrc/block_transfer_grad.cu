// Kernel: per-block transfer products with forward-mode (F, alpha)
// tangents sharing the primal's power-of-two rescale.
// The TANG instantiation of the transfer stream (transfer_stream.cuh,
// which holds the design and what bounds it), one candidate, three
// exports:
//   ngsf_block_transfer_grad     (GlSource) replaces
//                                ngsf_hmm_tpu/models/hmm_pallas.py:_k2_block_transfer_grad
//   ngsf_block_transfer_grad_bf16  the same on bfloat16 gl slabs
//   ngsf_block_transfer_grad_v1  (EmSource) replaces
//                                ngsf_hmm_tpu/models/hmm_pallas.py:_k_block_transfer_grad
// Its primal rows equal block_transfer.cu's output at B = 1 bit for bit:
// both run TransferLane's primal step.
#include "transfer_stream.cuh"

// MEM: the loads alone (chip_smoke.py's probe).
template <class Src, bool MEM = false>
static int launch(Src src, const float* F, const float* alpha, float* out,
                  int bs, int nb, int N, void* stream) {
    return launch_stream<true, 1, MEM>(src, F, alpha, out, bs, nb, N, 1,
                                       stream);
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
