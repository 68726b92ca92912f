// The 3x3 stride-1 pad-1 convolution of one output tile in float32, as the
// main loop of the float32 kernels in conv3x3.cu and spade_fused.cu. Each
// kernel adds its own epilogue to the accumulators this loop leaves in
// registers. (Their bfloat16 counterparts run on the TMA / wgmma conv engine,
// conv_engine.cuh.)
//
// A thread block owns an 8 x 8 tile of output pixels and one tile of output
// columns, and walks the input channels in chunks of 32. For each chunk it
// stages the pre-activated input halo (tile + 1 pixel all round, zeros
// outside the image: the convolution's padding, and zeros past the last
// channel) in shared memory and accumulates the nine taps in f32: 8 warps of
// one tile row each, lanes on output columns, plain FMA loops (exact in f32,
// and slow).
#pragma once

#include "mma_utils.cuh"

namespace hv {

constexpr int CT_NT = 256;                        // threads of a block

constexpr int CF_TH = 8, CF_TW = 8;               // f32 output tile
constexpr int CF_AH = CF_TH + 2, CF_AW = CF_TW + 2;
constexpr int CF_KC = 32;                         // input channels per chunk
constexpr int CF_AS = CF_KC + 4;                  // halo row stride (float4s)
constexpr int CF_SMEM_FLOATS = CF_AH * CF_AW * CF_AS;

// x: (B, H, W, CIN). wk: (9, CINP, NP), CINP = CIN padded to CF_KC with
// zeros. Warp = tile row, lane = one output column in each of G groups
// (col[g]); acc[g][j]: pixel j of the row. A: CF_SMEM_FLOATS floats.
template <int G>
__device__ __forceinline__ void conv_mainloop_f32(float (&acc)[G][CF_TW], const float* x,
                                                  int H, int W, int CIN, const float* wk,
                                                  int CINP, int NP, const int (&col)[G],
                                                  int pre_act, int b, int y0, int x0,
                                                  float* A) {
  const int tid = threadIdx.x, warp = tid >> 5;
  for (int c0 = 0; c0 < CINP; c0 += CF_KC) {
    for (int i = tid; i < CF_AH * CF_AW * CF_KC; i += CT_NT) {
      const int c = i % CF_KC, pix = i / CF_KC;
      const int gy = y0 - 1 + pix / CF_AW, gx = x0 - 1 + pix % CF_AW;
      float v = 0.f;
      if (c0 + c < CIN && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = pre_activate<float>(x[((size_t)(b * H + gy) * W + gx) * CIN + c0 + c], pre_act);
      A[pix * CF_AS + c] = v;
    }
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const float* at = A + ((warp + tap / 3) * CF_AW + tap % 3) * CF_AS;
      const float* wt = wk + ((size_t)tap * CINP + c0) * NP;
      for (int k = 0; k < CF_KC; k += 4) {
        float w[G][4];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) w[g][e] = __ldg(wt + (size_t)(k + e) * NP + col[g]);
#pragma unroll
        for (int j = 0; j < CF_TW; ++j) {
          const float4 a = *reinterpret_cast<const float4*>(at + j * CF_AS + k);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[g][j] = fmaf(a.x, w[g][0], acc[g][j]);
            acc[g][j] = fmaf(a.y, w[g][1], acc[g][j]);
            acc[g][j] = fmaf(a.z, w[g][2], acc[g][j]);
            acc[g][j] = fmaf(a.w, w[g][3], acc[g][j]);
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace hv
