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
// bfloat16 (the main path) runs as two launches on the TMA / wgmma conv
// engine (conv_engine.cuh), and the statistics come from the one-pass kernel
// of spade_fused.cu:
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
// float32 keeps the fused FMA kernel (spade_unit_kernel): each thread block
// owns a TH x TW output tile with all cout channels, stages the relu(actv)
// halo in shared memory, computes mod on the consumer's halo (recomputing
// gamma/beta there: 1.56x at 8x8) and runs the consumer conv from shared
// memory; exact in f32 and slow.
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
// (the bf16 ones 1000 + a CUresult if a tensor map cannot be encoded).

#include "spade_mod.cuh"

using namespace hv;

namespace {

constexpr int TH = 8;
constexpr int TW = 8;
constexpr int NT = 256;            // 8 warps
constexpr int NWARP = NT / 32;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// float32 version: plain FMA loops from shared memory.

struct Params {
  const float* x;       // (B, H, W, C)
  const float* noise;   // (B, H, W)
  const float* nscale;  // (C)
  const float* mu;      // (B, C)
  const float* rsig;    // (B, C)
  const float* actv;    // (B, H, W, NH), pre-relu
  const float* wgb;     // (9, NH/4, CP, 8): [g k0..k3 | b k0..k3]
  const float* bgb;     // (2, CP)
  const float* wc;      // (KS*KS, C, COUTP)
  const float* bc;      // (COUTP) (zeros: no bias)
  const float* res;     // (B, H, W, COUT) or null
  float* out;           // (B, H, W, COUT)
  int B, H, W, C, NH, COUT, CP, COUTP, pre_act;
};

template <int KS>
__global__ void __launch_bounds__(NT)
spade_unit_kernel(const Params p) {
  constexpr int R = KS / 2;
  constexpr int MH = TH + 2 * R, MW = TW + 2 * R;   // mod halo
  constexpr int AH = MH + 2, AW = MW + 2;           // relu(actv) halo
  constexpr int MP = MH * MW;
  constexpr int PPW = (MP + NWARP - 1) / NWARP;     // halo pixels per warp
  constexpr int OPW = TH * TW / NWARP;              // output pixels per warp

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* A = reinterpret_cast<float*>(smem_raw);
  float* M = A + AH * AW * p.NH;

  const int H = p.H, W = p.W, C = p.C, NH = p.NH;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = NH / 4;

  // ---- 1. relu(actv) halo -> A (zeros outside the image) -----------------
  for (int i = tid; i < AH * AW * nq; i += NT) {
    const int q = i % nq, pix = i / nq;
    const int gy = y0 - R - 1 + pix / AW, gx = x0 - R - 1 + pix % AW;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = load4(p.actv + ((size_t)(b * H + gy) * W + gx) * NH + q * 4);
      v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
    }
    *reinterpret_cast<float4*>(A + (size_t)pix * NH + q * 4) = v;
  }
  __syncthreads();

  // ---- 2. gamma|beta on the mod halo, modulate, activate -> M ------------
  // lanes own channels, warps own halo pixels; A reads are warp broadcasts.
  int aoff[PPW];
  const int p0 = warp * PPW;
#pragma unroll
  for (int j = 0; j < PPW; ++j) {
    const int q = min(p0 + j, MP - 1);   // clamped slots are computed, not stored
    aoff[j] = ((q / MW) * AW + (q % MW)) * NH;
  }
  for (int cb = 0; cb < p.CP; cb += 32) {
    const int c = cb + lane;
    float ag[PPW], ab[PPW];
#pragma unroll
    for (int j = 0; j < PPW; ++j) { ag[j] = 0.f; ab[j] = 0.f; }
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * AW + (tap % 3)) * NH;
      const float* wrow = p.wgb + ((size_t)tap * nq * p.CP + c) * 8;
      for (int kq = 0; kq < nq; ++kq) {
        // 8 consecutive weights [g k0..k3 | b k0..k3] of this channel
        const float4 wg = __ldg(reinterpret_cast<const float4*>(wrow + (size_t)kq * p.CP * 8));
        const float4 wb = __ldg(reinterpret_cast<const float4*>(wrow + (size_t)kq * p.CP * 8) + 1);
        const float* ak = A + toff + kq * 4;
#pragma unroll
        for (int j = 0; j < PPW; ++j) {
          const float4 a = load4(ak + aoff[j]);
          ag[j] = fmaf(a.x, wg.x, ag[j]); ag[j] = fmaf(a.y, wg.y, ag[j]);
          ag[j] = fmaf(a.z, wg.z, ag[j]); ag[j] = fmaf(a.w, wg.w, ag[j]);
          ab[j] = fmaf(a.x, wb.x, ab[j]); ab[j] = fmaf(a.y, wb.y, ab[j]);
          ab[j] = fmaf(a.z, wb.z, ab[j]); ab[j] = fmaf(a.w, wb.w, ab[j]);
        }
      }
    }
    if (c < C) {
      const float bgc = p.bgb[c], bbc = p.bgb[p.CP + c];
      const float nsc = p.nscale[c];
      const float muc = p.mu[b * C + c], rsc = p.rsig[b * C + c];
#pragma unroll
      for (int j = 0; j < PPW; ++j) {
        const int q = p0 + j;
        if (q >= MP) break;
        const int gy = y0 - R + q / MW, gx = x0 - R + q % MW;
        float m = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const size_t pix = (size_t)(b * H + gy) * W + gx;
          const float xn = p.x[pix * C + c] + p.noise[pix] * nsc;
          const float nrm = (xn - muc) * rsc;
          m = pre_activate<float>(nrm * (1.f + (ag[j] + bgc)) + (ab[j] + bbc), p.pre_act);
        }
        M[q * C + c] = m;
      }
    }
  }
  __syncthreads();

  // ---- 3. consumer conv from M, + bias [+ residual] -> out ---------------
  int moff[OPW];
#pragma unroll
  for (int j = 0; j < OPW; ++j) {
    const int o = warp * OPW + j;
    moff[j] = ((o / TW) * MW + (o % TW)) * C;
  }
  for (int ob = 0; ob < p.COUTP; ob += 32) {
    const int co = ob + lane;
    float acc[OPW];
#pragma unroll
    for (int j = 0; j < OPW; ++j) acc[j] = 0.f;
    for (int tap = 0; tap < KS * KS; ++tap) {
      const float* mt = M + ((tap / KS) * MW + (tap % KS)) * C;
      const float* wrow = p.wc + (size_t)tap * C * p.COUTP + co;
      for (int ci = 0; ci < C; ++ci) {
        const float w = wrow[(size_t)ci * p.COUTP];
#pragma unroll
        for (int j = 0; j < OPW; ++j) acc[j] = fmaf(mt[moff[j] + ci], w, acc[j]);
      }
    }
    if (co < p.COUT) {
      const float bco = p.bc[co];
#pragma unroll
      for (int j = 0; j < OPW; ++j) {
        const int o = warp * OPW + j;
        const int gy = y0 + o / TW, gx = x0 + o % TW;
        if (gy < H && gx < W) {
          const size_t idx = ((size_t)(b * H + gy) * W + gx) * p.COUT + co;
          float v = acc[j] + bco;
          if (p.res != nullptr) v += p.res[idx];
          p.out[idx] = v;
        }
      }
    }
  }
}

template <int KS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int R = KS / 2;
  constexpr int MH = TH + 2 * R, MW = TW + 2 * R;
  const size_t smem = ((size_t)(MH + 2) * (MW + 2) * p.NH + (size_t)MH * MW * p.C) * 4;
  cudaError_t err = cudaFuncSetAttribute(spade_unit_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.W + TW - 1) / TW, (p.H + TH - 1) / TH, p.B);
  spade_unit_kernel<KS><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the two stages on the conv engine.

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

// Shared memory of the float32 launch, so the wrapper can refuse a shape first.
size_t spade_unit_smem_bytes(int ks, int nh, int c) {
  const int r = ks / 2;
  const int mh = TH + 2 * r, mw = TW + 2 * r;
  return ((size_t)(mh + 2) * (mw + 2) * nh + (size_t)mh * mw * c) * 4;
}

// float32. ks: 1 or 3. pre_act: 0 none, 1 relu, 2 leaky 0.2. res may be
// null. Returns a cudaError_t (0 on success).
int spade_unit_forward(const void* x, const void* noise, const void* nscale,
                       const void* mu, const void* rsig, const void* actv,
                       const void* wgb, const void* bgb, const void* wc,
                       const void* bc, const void* res, void* out,
                       int B, int H, int W, int C, int NH, int COUT, int CP,
                       int COUTP, int ks, int pre_act, void* stream) {
  Params p;
  p.x = static_cast<const float*>(x); p.noise = static_cast<const float*>(noise);
  p.nscale = static_cast<const float*>(nscale);
  p.mu = static_cast<const float*>(mu); p.rsig = static_cast<const float*>(rsig);
  p.actv = static_cast<const float*>(actv); p.wgb = static_cast<const float*>(wgb);
  p.bgb = static_cast<const float*>(bgb); p.wc = static_cast<const float*>(wc);
  p.bc = static_cast<const float*>(bc); p.res = static_cast<const float*>(res);
  p.out = static_cast<float*>(out);
  p.B = B; p.H = H; p.W = W; p.C = C; p.NH = NH; p.COUT = COUT;
  p.CP = CP; p.COUTP = COUTP; p.pre_act = pre_act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ks == 3) return (int)launch<3>(p, s);
  if (ks == 1) return (int)launch<1>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
