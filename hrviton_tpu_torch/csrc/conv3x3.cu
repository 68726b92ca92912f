// Fused [pre-activation ->] 3x3 stride-1 pad-1 convolution [-> bias] for
// Hopper (sm_90a): two kernels, both on the TMA / wgmma conv engine
// (conv_engine.cuh): the halo tile of the unpadded NHWC input
// arrives by TMA with its zero border, the pre-activation is the engine's
// transform on A, the nine taps are wgmma products m64nBNk16 with the
// weights packed per stage on the host once per weight tensor
// (ops/conv_engine.py).
//
// conv3x3_wide_kernel replaces the TPU kernel hrviton_tpu/ops/conv3x3.py:_kernel
// (reached through _conv3x3_pallas, whose pl.pallas_call is at
// conv3x3.py:224): wide channel counts (the gate asks for CIN a multiple of
// 128). BN is chosen per call so that the small 128 x 96 sites still fill
// the card: 528 output channels are four tiles of 136. Rounding: the bias,
// rounded to bf16, joins the f32 accumulator and the sum is rounded once, as
// that kernel does.
//
// conv3x3_small_kernel replaces hrviton_tpu/ops/conv3x3.py:_views_kernel
// (through _conv3x3_views_pallas, pl.pallas_call at conv3x3.py:426): small
// channel counts (3 * CIN <= 128 and 3 * COUT <= 128; 9 -> 16, 32 -> 32 and
// 32 -> 3 on the generator's path). Rounding: the accumulator is rounded,
// then the bias is added in the output dtype, as that kernel does
// (conv_engine.cuh's BiasEpilogue). N tiles of 8, 16 or 32 columns (wgmma
// n8, n16, n32): COUT = 3 takes one tile of 8. A CIN that is a multiple of 8
// takes the engine as the wide kernel does; CIN = 9 (18-byte pixels, which
// no 4-D box addresses) takes its narrow inputs: the halo's rows by two
// boxes of a 3-D tensor map over (B, H, W * CIN) elements, spread into
// 16-channel swizzled rows in shared memory (the wrapper gives a CIN from 15
// to 42 that is no multiple of 8 as a copy padded to one). Not carried over:
// the TPU kernel streams row bands through a double buffer and shifts f32
// partial products with lane rotates.
//
// What bounds them on this card. The wide kernel is bound by operations: at
// 128 -> 528 a pixel needs 1.2 MFLOP against 1.3 KB of traffic; the engine's
// blocks of one halo tile that differ in the N tile are neighbours in the
// grid, so the input comes from device memory once and from L2 after. The
// small kernel is bound by bytes (9 -> 16: 50 B and 2.6 KFLOP a pixel): it
// reads the input once per tile (1.3x with the halo, from L2) and writes the
// output once.
//
// The kernels run for bf16 on the card; everything else runs the plain
// version (ops/_build.py:runs_kernel).
//
// Plain C interface for ctypes; the entry points return cudaGetLastError()
// (or 1000 + a CUresult if a tensor map cannot be encoded).

#include "conv_engine.cuh"

using namespace hv;

namespace {

// The wide kernel's epilogue: the bias (bf16-rounded, f32, zero-padded to the
// N tiles) added to the f32 accumulator, one rounding, 16-byte stores.
struct WideEpilogue : engine::PlainEpilogue {
  bf* out;              // (B, H, W, COUT)
  const float* bias;    // (NTILES * BN)
  int H, W, COUT;

  template <int BN>
  __device__ __forceinline__ void apply(const float (&d)[BN / 2], const Pre<BN>&,
                                        const Shared<BN>&, int b, int y, int x, int ntile,
                                        int lane, int w4) const {
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

// two blocks an SM: the narrow N tiles leave the consumers few accumulators,
// and a second block hides the latency of a stage (1.3-1.4x over one block
// with setmaxnreg, PERF.md §6)
template <int BN, bool NARROW>
__global__ void __launch_bounds__(engine::NT, 2)
    conv3x3_small_kernel(const __grid_constant__ CUtensorMap tmx, const unsigned char* wk,
                         const engine::BiasEpilogue epi, const engine::Geometry g) {
  engine::run<engine::Cfg<3, BN, NARROW, 2>>(&tmx, wk, epi, g);
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
  const WideEpilogue epi{{}, static_cast<bf*>(out), static_cast<const float*>(bias), H, W, COUT};
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

// bfloat16, small, on the conv engine. x: (B, H, W, CIN), contiguous,
// 16-byte aligned; CIN % 8 == 0 (box 0), or CIN < 15 with W * CIN % 8 == 0
// and box the elements of each of a halo row's two boxes (ops/conv3x3.py:
// narrow_box). wk: (CIN / 16 rounded up, NTILES, 9, BN, 16) bf16
// (ops/conv_engine.py:pack_kmajor); bias: (NTILES * BN) f32 rounded through
// bf16, zeros past COUT. BN: 8, 16 or 32. pre_act: 0 none, 1 relu, 2 leaky.
#define HV_SMALL(BN_, NARROW_)                                                              \
  case BN_ * 2 + NARROW_:                                                                   \
    return engine::launch<engine::Cfg<3, BN_, NARROW_, 2>>(conv3x3_small_kernel<BN_, NARROW_>, \
                                                           x, wk, B, H, W, CIN, NTILES,      \
                                                           pre_act, epi, s, box)
int conv3x3_small_forward_bf16(const void* x, const void* wk, const void* bias, void* out, int B,
                               int H, int W, int CIN, int COUT, int BN, int NTILES, int pre_act,
                               int box, void* stream) {
  if (COUT <= 0 || NTILES * BN < COUT || (box != 0) != (CIN % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const engine::BiasEpilogue epi{{}, static_cast<bf*>(out), static_cast<const float*>(bias),
                                 nullptr, H, W, COUT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (BN * 2 + (box != 0)) {
    HV_SMALL(8, false);
    HV_SMALL(8, true);
    HV_SMALL(16, false);
    HV_SMALL(16, true);
    HV_SMALL(32, false);
    HV_SMALL(32, true);
  }
  return (int)cudaErrorInvalidValue;
}
#undef HV_SMALL

}  // extern "C"
