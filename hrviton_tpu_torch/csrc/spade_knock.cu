// Knock variants of the fused unit's two bf16 kernels for Hopper (sm_90a):
// timing only, the counterpart of the JAX kernel's `knock`
// (hrviton_tpu/ops/spade_block.py:105, the stages :154-255), timed by
// hrviton_tpu_torch/tools/exp_block_knockout.py and chip_smoke.py phase 12.
//
// Each is spade_block.cu's spade_unit_gb_kernel or spade_unit_conv_kernel
// compiled with one knock mask (conv_engine.cuh's Cfg, spade_mod.cuh's
// epilogue): stage (a) actv_dma (KNOCK_NO_A: actv's TMA loads not issued, the
// output undefined), prod_dots (KNOCK_NO_DOTS: no gamma|beta loads or wgmma,
// the epilogue adds the biases to zero), prod_rolls (KNOCK_NO_ROLLS: every
// tap at the kx = 1 column), normalize, modulate (the epilogue's steps);
// stage (b), 3 x 3 only, cons_dots (KNOCK_NO_DOTS with CentreEpilogue: the
// accumulator is the centre pixel of act(mod), its first COUT channels) and
// cons_rolls. Only the single-tag masks of the JAX tool's eight tag sets
// (tools/exp_block_knockout.py:33-43) are instantiated. The knocked unit's
// plain version is ops/spade_block.py:spade_conv_ref(..., knock=).
//
// A file of its own: instantiated beside the production kernels in
// spade_block.cu, the variants changed the SASS of one of them (the 3 x 3
// consumer at BN = 128) though its source did not change; apart, every
// production kernel compiles as before (chip_smoke.py: ENGINE_SASS).
//
// What bounds a variant is what bounds the unit, less the stage it removes
// (chip_smoke.py phase 12 computes each bound). Plain C interface for
// ctypes; the entry points return cudaGetLastError(), or 1000 + a CUresult
// if a tensor map cannot be encoded.

#include "spade_mod.cuh"

using namespace hv;

namespace {

// The consumer's epilogue without products (knock cons_dots): the
// accumulator of channel co is channel co of act(mod) at the same pixel (the
// input `in`, CIN >= COUT channels), then BiasEpilogue's chain.
struct CentreEpilogue : engine::BiasEpilogue {
  const bf* in;                // (B, H, W, CIN)
  int CIN;

  template <int BN>
  __device__ __forceinline__ void apply(const float (&)[BN / 2], const Pre<BN>& pre,
                                        const Shared<BN>& s, int b, int y, int x0, int ntile,
                                        int lane, int w4) const {
    const int g = lane >> 2, t = lane & 3, n0 = ntile * BN, px = x0 + g;
    float d[BN / 2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int py = y + 2 * w4 + half;
      const bool ok = py < H && px < W;
      const size_t pix = ok ? (size_t)(b * H + py) * W + px : 0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = n0 + 8 * j + 2 * t;   // COUT % 8 == 0: co + 1 < COUT too
        const float2 v = ok && co < COUT ? engine::ld2(in + pix * CIN + co) : float2{0.f, 0.f};
        d[4 * j + 2 * half] = v.x;
        d[4 * j + 2 * half + 1] = v.y;
      }
    }
    BiasEpilogue::apply<BN>(d, pre, s, b, y, x0, ntile, lane, w4);
  }
};

// stage (a) with knock mask MASK: the engine's bits (< 8) and the epilogue's
template <int BN, int MASK>
__global__ void __launch_bounds__(engine::NT, 1)
    spade_unit_gb_knock_kernel(const __grid_constant__ CUtensorMap tmx, const unsigned char* wk,
                               const ModKnockEpilogue<MASK & ~7> epi, const engine::Geometry g) {
  engine::run<engine::Cfg<3, BN, false, 1, MASK & 7>>(&tmx, wk, epi, g);
}

// stage (b), 3 x 3, with the engine's knock mask MASK
template <int BN, int MASK, class Epi>
__global__ void __launch_bounds__(engine::NT, 1)
    spade_unit_conv_knock_kernel(const __grid_constant__ CUtensorMap tmx,
                                 const unsigned char* wk, const Epi epi,
                                 const engine::Geometry g) {
  engine::run<engine::Cfg<3, BN, false, 1, MASK>>(&tmx, wk, epi, g);
}

}  // namespace

extern "C" {

// Stage (a) compiled with knock mask `knock` (one of 1, 2, 4: the engine's
// KNOCK_NO_A, KNOCK_NO_DOTS, KNOCK_NO_ROLLS; 8, 16: KNOCK_NORMALIZE,
// KNOCK_MODULATE); the arguments of spade_unit_gb_forward_bf16.
#define HV_GBK(BN_, K_)                                                                      \
  case BN_ * 100 + K_: {                                                                     \
    const ModKnockEpilogue<K_ & ~7> ek{epi};                                                 \
    return engine::launch<engine::Cfg<3, BN_, false, 1, K_ & 7>>(                            \
        spade_unit_gb_knock_kernel<BN_, K_>, actv, wk, B, H, W, NH, NTILES, 1, ek, s);       \
  }
#define HV_GBK5(BN_) HV_GBK(BN_, 1) HV_GBK(BN_, 2) HV_GBK(BN_, 4) HV_GBK(BN_, 8) HV_GBK(BN_, 16)
int spade_unit_gb_knock_forward_bf16(const void* actv, const void* wk, const void* x,
                                     const void* noise, const void* nscale, const void* mu,
                                     const void* rsig, const void* bgb, void* mod, int B, int H,
                                     int W, int NH, int C, int CT, int NTILES, int pre_act,
                                     int knock, void* stream) {
  if (C <= 0 || C % 8 || CT % 8 || CT * NTILES < C) return (int)cudaErrorInvalidValue;
  const ModEpilogue epi{static_cast<__nv_bfloat16*>(mod), static_cast<const __nv_bfloat16*>(x),
                        static_cast<const float*>(noise), static_cast<const float*>(nscale),
                        static_cast<const float*>(mu), static_cast<const float*>(rsig),
                        static_cast<const float*>(bgb), H, W, C, CT, pre_act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (2 * CT * 100 + knock) {
    HV_GBK5(64)
    HV_GBK5(80)
    HV_GBK5(96)
  }
  return (int)cudaErrorInvalidValue;
}
#undef HV_GBK5
#undef HV_GBK

// Stage (b), 3 x 3 only, compiled with knock mask `knock`: 2 (cons_dots:
// KNOCK_NO_DOTS, the accumulator act(mod)'s centre pixel, COUT <= C) or 4
// (cons_rolls: KNOCK_NO_ROLLS); the arguments of spade_unit_conv_forward_bf16.
#define HV_CONVK(BN_)                                                                        \
  case BN_ * 100 + 2: {                                                                      \
    const CentreEpilogue ec{epi, static_cast<const bf*>(mod), C};                            \
    return engine::launch<engine::Cfg<3, BN_, false, 1, 2>>(                                 \
        spade_unit_conv_knock_kernel<BN_, 2, CentreEpilogue>, mod, wk, B, H, W, C, NTILES,   \
        0, ec, s);                                                                           \
  }                                                                                          \
  case BN_ * 100 + 4:                                                                        \
    return engine::launch<engine::Cfg<3, BN_, false, 1, 4>>(                                 \
        spade_unit_conv_knock_kernel<BN_, 4, engine::BiasEpilogue>, mod, wk, B, H, W, C,     \
        NTILES, 0, epi, s);
int spade_unit_conv_knock_forward_bf16(const void* mod, const void* wk, const void* bias,
                                       const void* res, void* out, int B, int H, int W, int C,
                                       int COUT, int KS, int BN, int NTILES, int knock,
                                       void* stream) {
  if (COUT <= 0 || COUT % 8 || BN * NTILES < COUT || KS != 3) return (int)cudaErrorInvalidValue;
  if (knock == 2 && COUT > C) return (int)cudaErrorInvalidValue;
  const engine::BiasEpilogue epi{{}, static_cast<__nv_bfloat16*>(out),
                                 static_cast<const float*>(bias),
                                 static_cast<const __nv_bfloat16*>(res), H, W, COUT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (BN * 100 + knock) {
    HV_CONVK(32)
    HV_CONVK(64)
    HV_CONVK(128)
  }
  return (int)cudaErrorInvalidValue;
}
#undef HV_CONVK

}  // extern "C"
