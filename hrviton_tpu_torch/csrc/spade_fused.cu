// Fused SPADE-norm modulation chain for Hopper (sm_90a).
//
// Replaces the TPU kernel hrviton_tpu/ops/spade_fused.py:_kernel (reached
// through _modulate_pallas, whose pl.pallas_call is at spade_fused.py:249).
// One launch computes, for one SPADENorm:
//
//   xn    = x + noise * nscale
//   norm  = (xn - mu) * rsig                       (mu, rsig: f32 instance stats, given)
//   gamma = conv3x3(relu(actv), Wg) + bg           (f32 accumulation)
//   beta  = conv3x3(relu(actv), Wb) + bb
//   out   = norm * (1 + gamma) + beta
//
// gamma, beta and norm never touch device memory, and relu(actv) is never
// written. The TPU kernel streams row bands of actv through a double buffer
// and merges taps into the contraction to suit its matrix unit; none of
// that is carried over. The kernel (spade_modulate_kernel) runs on the TMA /
// wgmma conv engine (conv_engine.cuh) as the fused unit's gamma|beta stage
// does, with the same epilogue and no activation (spade_mod.cuh): the actv
// halo arrives by TMA from the unpadded input, relu is the engine's
// transform on A, gamma and beta columns are interleaved in groups of 8 in
// N tiles of at most 96 columns so that each thread ends with gamma and beta
// of the same (pixel, channel), and the weights are packed once per weight
// tensor on the host (ops/spade_fused.py:gb_weights).
//
// What bounds it on this card: operations. A pixel of C channels needs
// 4 * 9 * NH * C flops against 2 * (2 * C + NH) + 4 bytes; at C = 80, NH = 128 that
// is 369 KFLOP against 0.6 KB. Blocks of one pixel tile that differ in the
// N tile are neighbours in the grid, so actv comes from device memory once
// and from L2 after.
//
// Rounding follows the plain PyTorch version (modulate_ref in
// ops/spade_fused.py): every intermediate it holds in the compute dtype is
// rounded here too; accumulation and the normalisation are f32.
//
// The kernels of this file run for bf16 on the card; everything else runs
// the plain version (ops/_build.py:runs_kernel).
//
// Below the modulation kernels, the one-pass instance statistics (a helper of
// both SPADE kernels).
//
// Plain C interface for ctypes; the entry points return cudaGetLastError()
// (the modulation's 1000 + a CUresult if its tensor map cannot be encoded).

#include "spade_mod.cuh"

using namespace hv;

namespace {

template <int BN>
__global__ void __launch_bounds__(engine::NT, 1)
    spade_modulate_kernel(const __grid_constant__ CUtensorMap tmx, const unsigned char* wk,
                          const ModEpilogue epi, const engine::Geometry g) {
  engine::run<engine::Cfg<3, BN>>(&tmx, wk, epi, g);
}

// ---------------------------------------------------------------------------
// The instance statistics of xn = x + noise * nscale, per (image, channel),
// in one pass over x: mu and rsig = 1 / sqrt(var + eps), f32. A helper of
// both SPADE kernels (this file's and spade_block.cu's), not the counterpart
// of a TPU kernel: the JAX package computes them with XLA outside its Pallas
// kernels (hrviton_tpu/ops/spade_block.py:_stats), as the plain version
// ops/spade_fused.py:instance_stats does with torch.var_mean.
//
// Bound by bytes: x is read once (the plain version reads it three times and
// writes an f32 copy). A block owns a chunk of one image's pixels; thread
// (channel group of 8, pixel lane) reads 16 bytes of a pixel (bf16) and walks
// the chunk's pixels P at a time, so a warp reads contiguous pixels. xn is
// formed as the plain version forms it (bf16: rounded to bf16 after the
// noise term is). A thread sums xn - k and its square in f32, k its first xn
// of the channel (shifted sums lose no digits to a large mean; sums in f64
// per thread ran slower on the H100); the block turns them into plain sums
// in f64, where E[xn^2] - mu^2 loses nothing that matters at these counts.
// The block's sums go to a workspace in a fixed order; a second, small
// launch adds the chunks of each (image, channel), also in a fixed order, so
// the result does not depend on scheduling.

constexpr int ST_NT = 256;

// xn as the plain version forms it in T (x is a value of T)
template <typename T> __device__ __forceinline__ float xn_value(float x, float nz, float nsc);
template <>
__device__ __forceinline__ float xn_value<__nv_bfloat16>(float x, float nz, float nsc) {
  return rt<__nv_bfloat16>(x + rt<__nv_bfloat16>(nz * nsc));
}

// 8 channels of a pixel from p, n of them in the tensor, as floats; vec:
// 16-byte aligned and n >= 8
template <typename T>
__device__ __forceinline__ void load_channels(const T* p, int n, bool vec, float (&v)[8]) {
  constexpr int PER = 16 / (int)sizeof(T);     // values in 16 bytes
  if (vec) {
#pragma unroll
    for (int i = 0; i < 8 / PER; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < PER; ++k) v[i * PER + k] = to_f(e[k]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < n ? to_f(p[e]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(ST_NT)
    instance_stats_partial_kernel(const T* x, const float* noise, const float* nscale,
                                  double* ws, int HW, int C, int chunk) {
  __shared__ double red[2][ST_NT * 8];
  const int G = (C + 7) / 8, P = ST_NT / G;
  const int tid = threadIdx.x, cg = tid % G, pl = tid / G, c0 = 8 * cg;
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const bool vec = C % 8 == 0;
  // per thread: sums of xn - k in f32, k = the thread's first xn of each
  // channel (so the sums stay near zero and keep their digits), then the
  // plain sums in f64 for the block's merge
  float k[8] = {}, s1[8] = {}, s2[8] = {};
  int n = 0;
  if (pl < P) {
    float nsc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) nsc[e] = c0 + e < C ? nscale[c0 + e] : 0.f;
    const int p1 = min(HW, (s + 1) * chunk);
#pragma unroll 4
    for (int p = s * chunk + pl; p < p1; p += P, ++n) {
      const size_t pix = (size_t)b * HW + p;
      const float nz = __ldg(noise + pix);
      float v[8];
      load_channels(x + pix * C + c0, C - c0, vec, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xn = xn_value<T>(v[e], nz, nsc[e]);
        if (n == 0) k[e] = xn;
        const float d = xn - k[e];
        s1[e] += d;
        s2[e] = fmaf(d, d, s2[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const double kk = k[e];
    red[0][tid * 8 + e] = s1[e] + n * kk;
    red[1][tid * 8 + e] = s2[e] + 2.0 * kk * s1[e] + n * kk * kk;
  }
  __syncthreads();
  for (int c = tid; c < C; c += ST_NT) {
    double a1 = 0.0, a2 = 0.0;
    for (int l = 0; l < P; ++l) {
      const int i = (l * G + c / 8) * 8 + c % 8;
      a1 += red[0][i];
      a2 += red[1][i];
    }
    double* o = ws + (((size_t)b * S + s) * C + c) * 2;
    o[0] = a1;
    o[1] = a2;
  }
}

__global__ void __launch_bounds__(ST_NT)
    instance_stats_finalize_kernel(const double* ws, float* mu, float* rsig, int HW, int C, int S,
                                   float eps) {
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += ST_NT) {
    double a1 = 0.0, a2 = 0.0;
    for (int s = 0; s < S; ++s) {
      const double* w = ws + (((size_t)b * S + s) * C + c) * 2;
      a1 += w[0];
      a2 += w[1];
    }
    const double m = a1 / HW, var = fmax(a2 / HW - m * m, 0.0);
    mu[b * C + c] = (float)m;
    rsig[b * C + c] = (float)(1.0 / sqrt(var + (double)eps));
  }
}

}  // namespace

extern "C" {

// bfloat16, on the conv engine. actv: (B, H, W, NH) pre-relu, NH % 8 == 0;
// x: (B, H, W, C), C % 8 == 0; all contiguous and 16-byte aligned. wk: (NH /
// 16 rounded up, NTILES, 9, 2 CT, 16) bf16, the gamma|beta columns of N tile
// j interleaved in groups of 8 (ops/spade_fused.py:pack_gb). bgb: (2, C) f32
// rounded through bf16. CT: channels of an N tile, 2 CT one of 64, 80, 96.
// out: (B, H, W, C) bf16.
#define HV_MOD(BN_)                                                                          \
  case BN_:                                                                                  \
    return engine::launch<engine::Cfg<3, BN_>>(spade_modulate_kernel<BN_>, actv, wk, B, H, W, \
                                               NH, NTILES, 1, epi, s)
int spade_modulate_forward_bf16(const void* actv, const void* wk, const void* x,
                                const void* noise, const void* nscale, const void* mu,
                                const void* rsig, const void* bgb, void* out, int B, int H,
                                int W, int NH, int C, int CT, int NTILES, void* stream) {
  if (C <= 0 || C % 8 || CT % 8 || CT * NTILES < C) return (int)cudaErrorInvalidValue;
  const ModEpilogue epi{static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(x),
                        static_cast<const float*>(noise), static_cast<const float*>(nscale),
                        static_cast<const float*>(mu), static_cast<const float*>(rsig),
                        static_cast<const float*>(bgb), H, W, C, CT, /*pre_act*/ 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (2 * CT) {
    HV_MOD(64);
    HV_MOD(80);
    HV_MOD(96);
  }
  return (int)cudaErrorInvalidValue;
}
#undef HV_MOD

// The instance statistics. x: (B, HW, C) bf16, contiguous, 16-byte aligned;
// noise: (B, HW) f32; nscale: (C) f32; ws: (B, S, C, 2) f64 scratch; mu,
// rsig: (B, C) f32. S: chunks of pixels per image (one block each). C <=
// 2048.
int instance_stats_forward(const void* x, const void* noise, const void* nscale, void* ws,
                           void* mu, void* rsig, int B, int HW, int C, int S, float eps,
                           void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || (C + 7) / 8 > ST_NT || S <= 0 || S > HW)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(S, B);
  const int chunk = (HW + S - 1) / S;
  const float* nz = static_cast<const float*>(noise);
  const float* nsc = static_cast<const float*>(nscale);
  double* w = static_cast<double*>(ws);
  instance_stats_partial_kernel<__nv_bfloat16><<<grid, ST_NT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), nz, nsc, w, HW, C, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  instance_stats_finalize_kernel<<<B, ST_NT, 0, s>>>(w, static_cast<float*>(mu),
                                                     static_cast<float*>(rsig), HW, C, S, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
