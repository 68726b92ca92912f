// The 3x3 stride-1 pad-1 convolution of one output tile, as the main loop of
// the kernels in conv3x3.cu and spade_fused.cu. Each kernel adds its own
// epilogue to the accumulators this loop leaves in registers.
//
// A thread block owns a 2-D tile of output pixels and one tile of output
// columns, and walks the input channels in chunks. For each chunk it stages
// the pre-activated input halo (tile + 1 pixel all round, zeros outside the
// image: the convolution's padding, and zeros past the last channel) in
// shared memory, brings the chunk's weights there, and accumulates the nine
// taps in f32.
//
//   bfloat16: tile 16 x 16 pixels, 8 warps of two tile rows each. A tap is a
//     product of (16 consecutive pixels of a halo row) x (K chunk) x (16 *
//     NFRAG columns) on the tensor cores: mma.sync m16n8k16, operands by
//     ldmatrix, weights by cp.async. Shared-memory row strides are the
//     chunk + 8 elements, so the 8 rows of an ldmatrix phase fall in
//     distinct banks.
//   float32: tile 8 x 8 pixels, 8 warps of one tile row each, lanes on
//     output columns, plain FMA loops (exact in f32, and slow).
#pragma once

#include "mma_utils.cuh"

namespace hv {

constexpr int CT_NT = 256;                        // threads of either version
constexpr int CT_TH = 16, CT_TW = 16;             // bf16 output tile
constexpr int CT_AH = CT_TH + 2, CT_AW = CT_TW + 2;

// bf16 shared memory, in bytes: halo (CT_AH x CT_AW x (kc + 8)) and one
// chunk of weights (9 * kc x (ntile + 8))
inline size_t ct_smem_bytes(int kc, int ntile) {
  return ((size_t)CT_AH * CT_AW * (kc + 8) + (size_t)9 * kc * (ntile + 8)) * 2;
}

// Channels [c0, c0 + kc) of x's halo, pre-activated, into A (row stride AS).
// CIN % 8 == 0: 16-byte loads. Otherwise a pixel is not 16-byte aligned:
// single elements, consecutive threads on consecutive addresses.
__device__ __forceinline__ void stage_halo_tc(bf* A, int AS, const bf* x, int H, int W,
                                              int CIN, int c0, int kc, int b, int y0,
                                              int x0, int pre_act, int tid) {
  if ((CIN & 7) == 0) {
    const int n8 = kc >> 3;
    for (int i = tid; i < CT_AH * CT_AW * n8; i += CT_NT) {
      const int q = i % n8, pix = i / n8;
      const int gy = y0 - 1 + pix / CT_AW, gx = x0 - 1 + pix % CT_AW;
      const int c = c0 + q * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < CIN) {
        load8(x + ((size_t)(b * H + gy) * W + gx) * CIN + c, v);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = pre_activate<bf>(v[k], pre_act);
      }
      store8(A + (size_t)pix * AS + q * 8, v);
    }
  } else {
    for (int i = tid; i < CT_AH * CT_AW * kc; i += CT_NT) {
      const int c = i % kc, pix = i / kc;
      const int gy = y0 - 1 + pix / CT_AW, gx = x0 - 1 + pix % CT_AW;
      float v = 0.f;
      if (c0 + c < CIN && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = pre_activate<bf>(
            to_f(x[((size_t)(b * H + gy) * W + gx) * CIN + c0 + c]), pre_act);
      A[(size_t)pix * AS + c] = from_f<bf>(v);
    }
  }
}

// Columns [n0, n0 + ntile) of a chunk's (rows x NP) weight matrix into Bs
// (row stride LDB), by cp.async; one commit group.
__device__ __forceinline__ void load_weights_tc(bf* Bs, int LDB, const bf* wchunk, int NP,
                                                int n0, int rows, int ntile, int tid) {
  const int segs = ntile >> 3;
  for (int i = tid; i < rows * segs; i += CT_NT) {
    const int r = i / segs, s = i % segs;
    cp_async16(Bs + (size_t)r * LDB + s * 8, wchunk + (size_t)r * NP + n0 + s * 8);
  }
  cp_async_commit();
}

// The nine taps of one staged chunk. acc[r][j][.]: tile row 2 * warp + r,
// columns 8 * j .. 8 * j + 7, in the m16n8 accumulator layout (lane = 4 g +
// t: [0], [1] at pixel g, columns 2t, 2t + 1; [2], [3] at pixel g + 8).
template <int NFRAG>
__device__ __forceinline__ void mma_chunk_tc(float (&acc)[2][2 * NFRAG][4], const bf* A,
                                             int AS, const bf* Bs, int LDB, int kc,
                                             int warp, int lane) {
  for (int tap = 0; tap < 9; ++tap) {
    // A: 16 pixels of a halo row (one per lane % 16), k-half by lane / 16
    const bf* a0 = A + ((size_t)(2 * warp + tap / 3) * CT_AW + tap % 3 + (lane & 15)) * AS +
                   (lane >> 4) * 8;
    // B: rows k of the tap (one per lane % 16), column half by lane / 16
    const bf* bs = Bs + (size_t)(tap * kc + (lane & 15)) * LDB + (lane >> 4) * 8;
    for (int kk = 0; kk < kc; kk += 16) {
      unsigned fa[2][4];
      ldsm_x4(fa[0], a0 + kk);
      ldsm_x4(fa[1], a0 + (size_t)CT_AW * AS + kk);
#pragma unroll
      for (int f = 0; f < NFRAG; ++f) {
        unsigned fb[4];
        ldsm_x4_t(fb, bs + (size_t)kk * LDB + f * 16);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mma_bf16(acc[r][2 * f], fa[r], fb[0], fb[1]);
          mma_bf16(acc[r][2 * f + 1], fa[r], fb[2], fb[3]);
        }
      }
    }
  }
}

// x: (B, H, W, CIN). wk: (nchunks, 9 * kc, NP) K x N, chunk q holding input
// channels [q * kc, (q + 1) * kc) of every tap (zeros past CIN). This block:
// image b, tile origin (y0, x0), columns [n0, n0 + 16 * NFRAG). smem:
// ct_smem_bytes(kc, 16 * NFRAG) bytes. Ends on a __syncthreads, so the
// caller may reuse smem at once.
template <int NFRAG>
__device__ __forceinline__ void conv_mainloop_tc(float (&acc)[2][2 * NFRAG][4], const bf* x,
                                                 int H, int W, int CIN, const bf* wk, int kc,
                                                 int nchunks, int NP, int n0, int pre_act,
                                                 int b, int y0, int x0, bf* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int AS = kc + 8, LDB = 16 * NFRAG + 8;
  bf* A = smem;
  bf* Bs = A + CT_AH * CT_AW * AS;
  for (int q = 0; q < nchunks; ++q) {
    load_weights_tc(Bs, LDB, wk + (size_t)q * 9 * kc * NP, NP, n0, 9 * kc, 16 * NFRAG, tid);
    stage_halo_tc(A, AS, x, H, W, CIN, q * kc, kc, b, y0, x0, pre_act, tid);
    cp_async_wait<0>();
    __syncthreads();
    mma_chunk_tc<NFRAG>(acc, A, AS, Bs, LDB, kc, warp, lane);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// float32

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
