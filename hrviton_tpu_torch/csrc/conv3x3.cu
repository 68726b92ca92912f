// Fused [pre-activation ->] 3x3 stride-1 pad-1 convolution [-> bias] for
// Hopper (sm_90a): two kernels.
//
// conv3x3_wide_kernel replaces the TPU kernel hrviton_tpu/ops/conv3x3.py:_kernel
// (reached through _conv3x3_pallas, whose pl.pallas_call is at
// conv3x3.py:224): wide channel counts (the gate asks for CIN a multiple of
// 128). It runs on the TMA / wgmma conv engine (conv_engine.cuh): the halo
// tile of the unpadded NHWC input arrives by TMA with its zero border, the
// pre-activation is the engine's transform on A, the nine taps are wgmma
// products m64nBNk16 with the weights packed per stage on the host
// (ops/conv_engine.py). BN is chosen per call so that the small 128 x 96
// sites still fill the card: 528 output channels are four tiles of 136.
// Rounding: the bias, rounded to bf16, joins the f32 accumulator and the sum
// is rounded once, as that kernel does.
//
// conv3x3_small_tc_kernel replaces hrviton_tpu/ops/conv3x3.py:_views_kernel
// (through _conv3x3_views_pallas, pl.pallas_call at conv3x3.py:426): small
// channel counts (3 * CIN <= 128 and 3 * COUT <= 128; 9 -> 16, 32 -> 32 and
// 32 -> 3 on the generator's path). Rounding: the accumulator is rounded,
// then the bias is added in the output dtype, as that kernel does. Not
// carried over block by block: the TPU kernel streams row bands through a
// double buffer and shifts f32 partial products with lane rotates; here a
// thread block owns a 16 x 16 pixel tile with a one-pixel halo in shared
// memory and runs each tap as a tensor-core product (conv_tile.cuh).
//
// What bounds them on this card. The wide kernel is bound by operations: at
// 128 -> 528 a pixel needs 1.2 MFLOP against 1.3 KB of traffic; the engine's
// blocks of one halo tile that differ in the N tile are neighbours in the
// grid, so the input comes from device memory once and from L2 after. The
// small kernel is bound by bytes (9 -> 16: 50 B and 2.6 KFLOP a pixel): it
// reads the input once per tile (1.27x with the halo) and writes each output
// row of the tile as one flat, coalesced span. With 9 or 3 channels a pixel
// is 18 or 6 bytes, so no pixel is 16-byte aligned: rows go through shared
// memory element by element, channels padded to the MMA tile there, and the
// store is masked.
//
// float32 inputs take one plain FMA kernel for both (exact in f32, slow).
//
// Plain C interface for ctypes; the entry points return cudaGetLastError()
// (the wide one 1000 + a CUresult if its tensor map cannot be encoded).

#include "conv_engine.cuh"
#include "conv_tile.cuh"

using namespace hv;

namespace {

struct ConvParams {
  const void* x;        // (B, H, W, CIN)
  const void* wk;       // packed weights (see the entry points)
  const float* bias;    // (NP), rounded through the dtype, zeros past COUT
  void* out;            // (B, H, W, COUT)
  int B, H, W, CIN, COUT, KC, NP, pre_act;
};

// The wide kernel's epilogue: the bias (bf16-rounded, f32, zero-padded to the
// N tiles) added to the f32 accumulator, one rounding, 16-byte stores.
struct WideEpilogue {
  bf* out;              // (B, H, W, COUT)
  const float* bias;    // (NTILES * BN)
  int H, W, COUT;

  template <int BN> struct Pre {};
  template <int BN>
  __device__ __forceinline__ Pre<BN> load(int, int, int, int, int, int) const {
    return {};
  }

  template <int BN>
  __device__ __forceinline__ void apply(const float (&d)[BN / 2], const Pre<BN>&, int b, int y,
                                        int x, int ntile, int lane, int w4) const {
    const int g = lane >> 2, t = lane & 3, n0 = ntile * BN, px = x + g;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int py = y + 2 * w4 + half;
      const bool ok = py < H && px < W;
      bf* o = out + (ok ? ((size_t)(b * H + py) * W + px) * COUT : 0);
      unsigned w[BN / 8];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + n0 + 8 * j + 2 * t));
        w[j] = engine::pack2(d[4 * j + 2 * half] + bb.x, d[4 * j + 2 * half + 1] + bb.y);
      }
      engine::store_words<BN / 8>(o, w, n0, COUT, ok, t);
    }
  }
};

template <int BN>
__global__ void __launch_bounds__(engine::NT, 1)
    conv3x3_wide_kernel(const __grid_constant__ CUtensorMap tmx, const unsigned char* wk,
                        const WideEpilogue epi, const engine::Geometry g) {
  engine::run<engine::Cfg<3, BN>>(&tmx, wk, epi, g);
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

// bfloat16, wide, on the conv engine. x: (B, H, W, CIN), CIN % 8 == 0,
// contiguous, 16-byte aligned. wk: (CIN / 16 rounded up, NTILES, 9, BN, 16)
// bf16 (ops/conv_engine.py:pack_kmajor). bias: (NTILES * BN) f32, zeros past
// COUT. BN: 32, 64, 96, 128 or 136. pre_act: 0 none, 1 relu, 2 leaky.
#define HV_WIDE(BN_)                                                                   \
  case BN_:                                                                            \
    return engine::launch<engine::Cfg<3, BN_>>(conv3x3_wide_kernel<BN_>, x, wk, B, H, W, \
                                               CIN, NTILES, pre_act, epi, s)
int conv3x3_wide_forward_bf16(const void* x, const void* wk, const void* bias, void* out, int B,
                              int H, int W, int CIN, int COUT, int BN, int NTILES, int pre_act,
                              void* stream) {
  if (COUT <= 0 || NTILES * BN < COUT) return (int)cudaErrorInvalidValue;
  const WideEpilogue epi{static_cast<bf*>(out), static_cast<const float*>(bias), H, W, COUT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (BN) {
    HV_WIDE(32);
    HV_WIDE(64);
    HV_WIDE(96);
    HV_WIDE(128);
    HV_WIDE(136);
  }
  return (int)cudaErrorInvalidValue;
}
#undef HV_WIDE

// bfloat16, small: wk: (9 * CINP, NP) bf16, CINP = CIN padded to 16 and NP =
// COUT padded to 16, both at most 48. bias: (NP) f32.
int conv3x3_small_forward_bf16(const void* x, const void* wk, const void* bias, void* out,
                               int B, int H, int W, int CIN, int COUT, int CINP, int NP,
                               int pre_act, void* stream) {
  if (CINP % 16 || CINP < CIN || CINP > 48 || NP % 16 || NP < COUT || NP > 48)
    return (int)cudaErrorInvalidValue;
  ConvParams p{x, wk, static_cast<const float*>(bias), out, B, H, W, CIN, COUT,
               CINP, NP, pre_act};
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
               CINP, NP, pre_act};
  dim3 grid((W + CF_TW - 1) / CF_TW * (NP / 32), (H + CF_TH - 1) / CF_TH, B);
  conv3x3_f32_kernel<<<grid, CT_NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
