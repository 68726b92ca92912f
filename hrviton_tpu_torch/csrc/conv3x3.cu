// Fused [pre-activation ->] 3x3 stride-1 pad-1 convolution [-> bias] for
// Hopper (sm_90a): two kernels.
//
// conv3x3_tc_kernel replaces the TPU kernel hrviton_tpu/ops/conv3x3.py:_kernel
// (reached through _conv3x3_pallas, whose pl.pallas_call is at
// conv3x3.py:224): wide channel counts (CIN a multiple of 32; the gate asks
// for a multiple of 128). Rounding: the bias joins the f32 accumulator and
// the sum is rounded once, as that kernel does.
//
// conv3x3_small_tc_kernel replaces hrviton_tpu/ops/conv3x3.py:_views_kernel
// (through _conv3x3_views_pallas, pl.pallas_call at conv3x3.py:426): small
// channel counts (3 * CIN <= 128 and 3 * COUT <= 128; 9 -> 16, 32 -> 32 and
// 32 -> 3 on the generator's path). Rounding: the accumulator is rounded,
// then the bias is added in the output dtype, as that kernel does.
//
// Neither is carried over block by block. The TPU kernels stream row bands
// through a double buffer and shift f32 partial products with lane rotates;
// here a thread block owns a 16 x 16 pixel tile with a one-pixel halo in
// shared memory and runs each tap as a tensor-core product (conv_tile.cuh).
//
// What bounds them on this card. The wide kernel is bound by operations: at
// 128 -> 528 a pixel needs 1.2 MFLOP against 1.3 KB of traffic. Its blocks
// walk CIN in chunks of 32 channels with all 64 columns of a column tile in
// registers; blocks of one pixel tile that differ in the column tile are
// neighbours in the grid, so the input is read from device memory once and
// from L2 after. The small kernel is bound by bytes (9 -> 16: 50 B and 2.6
// KFLOP a pixel): it reads the input once per tile (1.27x with the halo)
// and writes each output row of the tile as one flat, coalesced span. With
// 9 or 3 channels a pixel is 18 or 6 bytes, so no pixel is 16-byte aligned:
// rows go through shared memory element by element, channels padded to the
// MMA tile there, and the store is masked.
//
// float32 inputs take one plain FMA kernel for both (exact in f32, slow).
//
// Plain C interface for ctypes; the entry points return cudaGetLastError().

#include "conv_tile.cuh"

using namespace hv;

namespace {

constexpr int WIDE_KC = 32;          // input channels per chunk, wide kernel
constexpr int WIDE_NFRAG = 4;        // 64 output columns per block

struct ConvParams {
  const void* x;        // (B, H, W, CIN)
  const void* wk;       // packed weights (see the entry points)
  const float* bias;    // (NP), rounded through the dtype, zeros past COUT
  void* out;            // (B, H, W, COUT)
  int B, H, W, CIN, COUT, KC, NCHUNKS, NP, pre_act;
};

__global__ void __launch_bounds__(CT_NT, 2)
conv3x3_tc_kernel(const ConvParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nct = p.NP / (16 * WIDE_NFRAG);
  const int ct = blockIdx.x % nct, tx = blockIdx.x / nct;
  const int b = blockIdx.z, y0 = blockIdx.y * CT_TH, x0 = tx * CT_TW;
  const int n0 = ct * 16 * WIDE_NFRAG;
  float acc[2][2 * WIDE_NFRAG][4] = {};
  conv_mainloop_tc<WIDE_NFRAG>(acc, static_cast<const bf*>(p.x), p.H, p.W, p.CIN,
                               static_cast<const bf*>(p.wk), p.KC, p.NCHUNKS, p.NP, n0,
                               p.pre_act, b, y0, x0, reinterpret_cast<bf*>(smem_raw));
  // accumulator + bias, one round, straight from the registers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf* out = static_cast<bf*>(p.out);
  const bool pairs = (p.COUT & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gy = y0 + 2 * warp + r;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + g + 8 * half;
      if (gy >= p.H || gx >= p.W) continue;
      bf* o = out + ((size_t)(b * p.H + gy) * p.W + gx) * p.COUT;
#pragma unroll
      for (int j = 0; j < 2 * WIDE_NFRAG; ++j) {
        const int co = n0 + j * 8 + 2 * t;
        const float v0 = acc[r][j][2 * half] + p.bias[co];
        const float v1 = acc[r][j][2 * half + 1] + p.bias[co + 1];
        if (pairs && co + 1 < p.COUT) {
          *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < p.COUT) o[co] = from_f<bf>(v0);
          if (co + 1 < p.COUT) o[co + 1] = from_f<bf>(v1);
        }
      }
    }
  }
}

template <int NFRAG>
__global__ void __launch_bounds__(CT_NT, 2)
conv3x3_small_tc_kernel(const ConvParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf* smem = reinterpret_cast<bf*>(smem_raw);
  const int b = blockIdx.z, y0 = blockIdx.y * CT_TH, x0 = blockIdx.x * CT_TW;
  float acc[2][2 * NFRAG][4] = {};
  conv_mainloop_tc<NFRAG>(acc, static_cast<const bf*>(p.x), p.H, p.W, p.CIN,
                          static_cast<const bf*>(p.wk), p.KC, 1, p.NP, 0, p.pre_act, b,
                          y0, x0, smem);
  // round, add the bias in bf16, and stage the tile as CT_TH flat rows of
  // CT_TW * COUT elements (the halo's space is free after the main loop)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int span = CT_TW * p.COUT;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 2 * NFRAG; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = j * 8 + 2 * t + e;
          if (co < p.COUT)
            smem[(2 * warp + r) * span + (g + 8 * half) * p.COUT + co] =
                from_f<bf>(rt<bf>(acc[r][j][2 * half + e]) + p.bias[co]);
        }
  __syncthreads();
  bf* out = static_cast<bf*>(p.out);
  for (int i = tid; i < CT_TH * span; i += CT_NT) {
    const int r = i / span, j = i % span;
    const int gy = y0 + r, gx = x0 + j / p.COUT;
    if (gy < p.H && gx < p.W)
      out[((size_t)(b * p.H + gy) * p.W + x0) * p.COUT + j] = smem[i];
  }
}

// float32, any channel counts: warp = tile row, lane = output channel.
__global__ void __launch_bounds__(CT_NT)
conv3x3_f32_kernel(const ConvParams p) {
  __shared__ __align__(16) float A[CF_SMEM_FLOATS];
  const int nct = p.NP / 32;
  const int ct = blockIdx.x % nct, tx = blockIdx.x / nct;
  const int b = blockIdx.z, y0 = blockIdx.y * CF_TH, x0 = tx * CF_TW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col[1] = {ct * 32 + lane};
  float acc[1][CF_TW] = {};
  conv_mainloop_f32<1>(acc, static_cast<const float*>(p.x), p.H, p.W, p.CIN,
                       static_cast<const float*>(p.wk), p.KC, p.NP, col, p.pre_act, b, y0,
                       x0, A);
  const int co = col[0], gy = y0 + warp;
  if (co >= p.COUT || gy >= p.H) return;
  float* out = static_cast<float*>(p.out);
  const float bco = p.bias[co];
#pragma unroll
  for (int j = 0; j < CF_TW; ++j) {
    const int gx = x0 + j;
    if (gx < p.W) out[((size_t)(b * p.H + gy) * p.W + gx) * p.COUT + co] = acc[0][j] + bco;
  }
}

// nct column tiles of ntile columns; at least min_smem bytes of shared memory
template <typename K>
cudaError_t launch_tc(K kernel, const ConvParams& p, int ntile, int nct, size_t min_smem,
                      cudaStream_t stream) {
  size_t smem = ct_smem_bytes(p.KC, ntile);
  if (min_smem > smem) smem = min_smem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.W + CT_TW - 1) / CT_TW * nct, (p.H + CT_TH - 1) / CT_TH, p.B);
  kernel<<<grid, CT_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16, wide: CIN % 32 == 0. wk: (CIN / 32, 9 * 32, NP) bf16, NP = COUT
// padded to 64 with zeros. bias: (NP) f32. pre_act: 0 none, 1 relu, 2 leaky.
int conv3x3_forward_bf16(const void* x, const void* wk, const void* bias, void* out, int B,
                         int H, int W, int CIN, int COUT, int NP, int pre_act, void* stream) {
  if (CIN <= 0 || CIN % WIDE_KC || NP % (16 * WIDE_NFRAG) || NP < COUT)
    return (int)cudaErrorInvalidValue;
  ConvParams p{x, wk, static_cast<const float*>(bias), out, B, H, W, CIN, COUT,
               WIDE_KC, CIN / WIDE_KC, NP, pre_act};
  return (int)launch_tc(conv3x3_tc_kernel, p, 16 * WIDE_NFRAG, NP / (16 * WIDE_NFRAG), 0,
                        static_cast<cudaStream_t>(stream));
}

// bfloat16, small: wk: (9 * CINP, NP) bf16, CINP = CIN padded to 16 and NP =
// COUT padded to 16, both at most 48. bias: (NP) f32.
int conv3x3_small_forward_bf16(const void* x, const void* wk, const void* bias, void* out,
                               int B, int H, int W, int CIN, int COUT, int CINP, int NP,
                               int pre_act, void* stream) {
  if (CINP % 16 || CINP < CIN || CINP > 48 || NP % 16 || NP < COUT || NP > 48)
    return (int)cudaErrorInvalidValue;
  ConvParams p{x, wk, static_cast<const float*>(bias), out, B, H, W, CIN, COUT,
               CINP, 1, NP, pre_act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = (size_t)CT_TH * CT_TW * COUT * 2;   // the staged output tile
  if (NP == 16) return (int)launch_tc(conv3x3_small_tc_kernel<1>, p, NP, 1, rows, s);
  if (NP == 32) return (int)launch_tc(conv3x3_small_tc_kernel<2>, p, NP, 1, rows, s);
  return (int)launch_tc(conv3x3_small_tc_kernel<3>, p, NP, 1, rows, s);
}

// float32, any channel counts. wk: (9, CINP, NP) f32, CINP = CIN padded to
// 32 and NP = COUT padded to 32 with zeros. bias: (NP) f32.
int conv3x3_forward_f32(const void* x, const void* wk, const void* bias, void* out, int B,
                        int H, int W, int CIN, int COUT, int CINP, int NP, int pre_act,
                        void* stream) {
  if (CINP % CF_KC || CINP < CIN || NP % 32 || NP < COUT) return (int)cudaErrorInvalidValue;
  ConvParams p{x, wk, static_cast<const float*>(bias), out, B, H, W, CIN, COUT,
               CINP, 1, NP, pre_act};
  dim3 grid((W + CF_TW - 1) / CF_TW * (NP / 32), (H + CF_TH - 1) / CF_TH, B);
  conv3x3_f32_kernel<<<grid, CT_NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
