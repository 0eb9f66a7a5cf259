// Kernel: per-block transfer products with forward-mode (F, alpha)
// tangents sharing the primal's power-of-two rescale.
// Replaces ngsf_hmm_tpu/models/hmm_pallas.py:_k2_block_transfer_grad.
// Bound by bytes on paper (two gl slabs read once, 13 floats per lane
// written), but with ~110 float operations per cell and no FMA
// contraction it sits near the float32 rate as well.
#include "hmm_common.cuh"

__global__ void k_block_transfer_grad(
    const float* __restrict__ g0, const float* __restrict__ g2,
    const float* __restrict__ fc, const float* __restrict__ dc,
    const float* __restrict__ Fp, const float* __restrict__ ap,
    float* __restrict__ out, int bs, int nb, int N) {
    const long long lanes = (long long)nb * N;
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int j = (int)(lane / N);
    const int n = (int)(lane - (long long)j * N);
    const float F = Fp[n];
    const float a = ap[n];

    float c00 = 1.0f, c01 = 0.0f, c10 = 0.0f, c11 = 1.0f;
    float f00 = 0.0f, f01 = 0.0f, f10 = 0.0f, f11 = 0.0f;  // d/dF
    float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;  // d/dalpha
    int ex = 0;
    for (int r0 = 0; r0 < bs; r0 += NGSF_UNROLL) {
        float l0[NGSF_UNROLL], l2[NGSF_UNROLL], ff[NGSF_UNROLL],
            dd[NGSF_UNROLL];
        chunk_load(g0, g2, fc, dc, r0, bs, nb, j, lane, lanes, l0, l2, ff, dd);
#pragma unroll
        for (int u = 0; u < NGSF_UNROLL; ++u) {
            const SiteK k = site_load(l0[u], l2[u], ff[u], dd[u], a);
            float m00, m01, m10, m11;
            site_matrix(k, F, m00, m01, m10, m11);
            // tangents of M: dM/dF = onem [[-e0, e1], [-e0, e1]];
            // dM/dalpha = d x [[-F e0, F e1], [(1-F) e0, -(1-F) e1]],
            // with d x forced to 0 at a chromosome break (d = inf, x = 0)
            const float dxp = k.x > 0.0f ? k.d * k.x : 0.0f;
            const float oe0 = k.onem * k.e0;
            const float oe1 = k.onem * k.e1;
            const float fd = F * dxp;
            const float gd = (1.0f - F) * dxp;
            const float p00 = -fd * k.e0, p01 = fd * k.e1;
            const float p10 = gd * k.e0, p11 = -gd * k.e1;

            // primal: the same expressions as k_block_transfer
            const float n00 = c00 * m00 + c01 * m10;
            const float n01 = c00 * m01 + c01 * m11;
            const float n10 = c10 * m00 + c11 * m10;
            const float n11 = c10 * m01 + c11 * m11;
            // product rule: d(C M) = dC M + C dM
            const float nf00 = (f00 * m00 + f01 * m10) + (c00 * -oe0 + c01 * -oe0);
            const float nf01 = (f00 * m01 + f01 * m11) + (c00 * oe1 + c01 * oe1);
            const float nf10 = (f10 * m00 + f11 * m10) + (c10 * -oe0 + c11 * -oe0);
            const float nf11 = (f10 * m01 + f11 * m11) + (c10 * oe1 + c11 * oe1);
            const float na00 = (a00 * m00 + a01 * m10) + (c00 * p00 + c01 * p10);
            const float na01 = (a00 * m01 + a01 * m11) + (c00 * p01 + c01 * p11);
            const float na10 = (a10 * m00 + a11 * m10) + (c10 * p00 + c11 * p10);
            const float na11 = (a10 * m01 + a11 * m11) + (c10 * p01 + c11 * p11);
            const float sc =
                pow2_scale(fmaxf(max4(n00, n01, n10, n11), NGSF_TINY), ex);
            c00 = n00 * sc; c01 = n01 * sc; c10 = n10 * sc; c11 = n11 * sc;
            f00 = nf00 * sc; f01 = nf01 * sc; f10 = nf10 * sc; f11 = nf11 * sc;
            a00 = na00 * sc; a01 = na01 * sc; a10 = na10 * sc; a11 = na11 * sc;
        }
    }
    // out [13, nb, N]
    float* o = out + lane;
    o[0] = c00; o[lanes] = c01; o[2 * lanes] = c10; o[3 * lanes] = c11;
    o[4 * lanes] = f00; o[5 * lanes] = f01; o[6 * lanes] = f10;
    o[7 * lanes] = f11;
    o[8 * lanes] = a00; o[9 * lanes] = a01; o[10 * lanes] = a10;
    o[11 * lanes] = a11;
    o[12 * lanes] = (float)ex * NGSF_LN2;
}

extern "C" int ngsf_block_transfer_grad(const float* g0, const float* g2,
                                        const float* fc, const float* dc,
                                        const float* F, const float* alpha,
                                        float* out, int bs, int nb, int N,
                                        void* stream) {
    const int threads = 128;
    const long long lanes = (long long)nb * N;
    const unsigned grid = (unsigned)((lanes + threads - 1) / threads);
    k_block_transfer_grad<<<grid, threads, 0, (cudaStream_t)stream>>>(
        g0, g2, fc, dc, F, alpha, out, bs, nb, N);
    return (int)cudaGetLastError();
}
