// The fused {SPADE-norm -> activation -> consumer conv} unit for Hopper
// (sm_90a).
//
// Replaces the TPU kernel hrviton_tpu/ops/spade_block.py:_kernel (reached
// through fused_spade_conv, whose pl.pallas_call is at spade_block.py:337).
// One unit computes, for one {SPADENorm, conv} pair of a SPADEResBlock:
//
//   xn   = x + noise * nscale
//   norm = (xn - mu) * rsig                      (mu, rsig: f32 instance stats)
//   g|b  = conv3x3(relu(actv), Wg|Wb) + bg|bb    (f32 accumulation)
//   mod  = act(norm * (1 + g) + b)               act: none | relu | leaky 0.2
//   out  = conv(mod, Wc) + bc [+ residual]       3x3 pad 1, or 1x1
//
// It runs as two launches on the TMA / wgmma conv engine (conv_engine.cuh),
// and the statistics come from the one-pass kernel of spade_fused.cu:
//   (a) spade_unit_gb_kernel: the gamma|beta product with the modulation and
//       the activation in its epilogue (spade_mod.cuh, shared with the fused
//       modulation of spade_fused.cu), storing act(mod) in bf16. N tiles of
//       at most 96 columns (C = 144: three tiles of 48 channels; C = 80: two
//       of 40), since the consumers hold 2 x BN / 2 accumulators a thread and
//       the epilogue's operands beside them;
//   (b) spade_unit_conv_kernel: the consumer conv (3x3 or 1x1, C -> COUT) of
//       act(mod) on the same engine; its epilogue (conv_engine.cuh's
//       BiasEpilogue) rounds the accumulator, adds the bias in bf16, then the
//       residual in bf16.
// Why two launches and not one: the gamma|beta product is 4.06 of the six
// units' 4.48 TFLOP at 1024x768; a fused block would recompute it on a halo
// of its tile (1.3-1.5x that work), and one 16-channel stage of the C = 144
// gamma|beta weights alone is 83 KB, so a fused block holds no ring.
// Writing act(mod) once and reading it back costs ~1 ms of bytes for the six
// units, and both halves run on the one engine.
//
// The kernels run for bf16 on the card; everything else runs the plain
// version (ops/_build.py:runs_kernel).
//
// What bounds the unit on this card: at 1024x768 the six units of the
// generator's up_3/up_4 blocks do ~1.12 TFLOP per image against ~1.5 GB of
// compulsory traffic: operations (bf16 tensor-core bound ~1.1 ms per image
// at 989 TFLOP/s). Stage (b) alone is bound by bytes.
//
// Rounding follows the plain PyTorch version (spade_conv_ref in
// ops/spade_block.py): every intermediate that the plain version holds in
// the compute dtype is rounded through T here (rt<T>), accumulations are f32.
//
// Plain C interface for ctypes; the entry points return cudaGetLastError()
// (or 1000 + a CUresult if a tensor map cannot be encoded).

#include "spade_mod.cuh"

using namespace hv;

namespace {

template <int BN>
__global__ void __launch_bounds__(engine::NT, 1)
    spade_unit_gb_kernel(const __grid_constant__ CUtensorMap tmx, const unsigned char* wk,
                         const ModEpilogue epi, const engine::Geometry g) {
  engine::run<engine::Cfg<3, BN>>(&tmx, wk, epi, g);
}

template <int KS, int BN>
__global__ void __launch_bounds__(engine::NT, 1)
    spade_unit_conv_kernel(const __grid_constant__ CUtensorMap tmx, const unsigned char* wk,
                           const engine::BiasEpilogue epi, const engine::Geometry g) {
  engine::run<engine::Cfg<KS, BN>>(&tmx, wk, epi, g);
}

}  // namespace

extern "C" {

// Stage (a), bfloat16: act(mod) of a unit. actv: (B, H, W, NH) pre-relu, NH %
// 8 == 0; x: (B, H, W, C), C % 8 == 0; all contiguous and 16-byte aligned.
// wk: (NH / 16 rounded up, NTILES, 9, 2 CT, 16) bf16, the gamma|beta columns
// of N tile j interleaved in groups of 8 (ops/spade_fused.py:pack_gb). bgb:
// (2, C) f32. CT: channels of an N tile, 2 CT one of 64, 80, 96.
// pre_act: 0 none, 1 relu, 2 leaky 0.2. mod: (B, H, W, C) bf16.
#define HV_GB(BN_)                                                                       \
  case BN_:                                                                              \
    return engine::launch<engine::Cfg<3, BN_>>(spade_unit_gb_kernel<BN_>, actv, wk, B, H, W, \
                                               NH, NTILES, 1, epi, s)
int spade_unit_gb_forward_bf16(const void* actv, const void* wk, const void* x, const void* noise,
                               const void* nscale, const void* mu, const void* rsig,
                               const void* bgb, void* mod, int B, int H, int W, int NH, int C,
                               int CT, int NTILES, int pre_act, void* stream) {
  if (C <= 0 || C % 8 || CT % 8 || CT * NTILES < C) return (int)cudaErrorInvalidValue;
  const ModEpilogue epi{static_cast<__nv_bfloat16*>(mod), static_cast<const __nv_bfloat16*>(x),
                        static_cast<const float*>(noise), static_cast<const float*>(nscale),
                        static_cast<const float*>(mu), static_cast<const float*>(rsig),
                        static_cast<const float*>(bgb), H, W, C, CT, pre_act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (2 * CT) {
    HV_GB(64);
    HV_GB(80);
    HV_GB(96);
  }
  return (int)cudaErrorInvalidValue;
}
#undef HV_GB

// Stage (b), bfloat16: out = conv(mod, Wc) + bc [+ res]. mod: (B, H, W, C),
// C % 8 == 0; wk: (C / 16 rounded up, NTILES, KS * KS, BN, 16) bf16; bias:
// (NTILES * BN) f32 rounded through bf16; res: (B, H, W, COUT) or null;
// COUT % 8 == 0. KS: 1 or 3; BN: 32, 64 or 128.
#define HV_CONV(KS_, BN_)                                                                  \
  case KS_ * 1000 + BN_:                                                                   \
    return engine::launch<engine::Cfg<KS_, BN_>>(spade_unit_conv_kernel<KS_, BN_>, mod, wk, B, \
                                                 H, W, C, NTILES, 0, epi, s)
int spade_unit_conv_forward_bf16(const void* mod, const void* wk, const void* bias,
                                 const void* res, void* out, int B, int H, int W, int C, int COUT,
                                 int KS, int BN, int NTILES, void* stream) {
  if (COUT <= 0 || COUT % 8 || BN * NTILES < COUT) return (int)cudaErrorInvalidValue;
  const engine::BiasEpilogue epi{{}, static_cast<__nv_bfloat16*>(out),
                                 static_cast<const float*>(bias),
                                 static_cast<const __nv_bfloat16*>(res), H, W, COUT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (KS * 1000 + BN) {
    HV_CONV(1, 32);
    HV_CONV(1, 64);
    HV_CONV(1, 128);
    HV_CONV(3, 32);
    HV_CONV(3, 64);
    HV_CONV(3, 128);
  }
  return (int)cudaErrorInvalidValue;
}
#undef HV_CONV

}  // extern "C"
