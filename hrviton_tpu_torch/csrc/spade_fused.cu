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
// that is carried over. Here a thread block owns a 16 x 16 pixel tile and
// 32 of the channels: the main loop of conv_tile.cuh runs the 3x3 over the
// relu(actv) halo with 64 weight columns, [gamma | beta] of those 32
// channels, so each thread ends with gamma and beta of the same (pixel,
// channel) in its registers and applies the chain to x there.
//
// What bounds it on this card: operations. A pixel of C channels needs
// 4 * 9 * NH * C flops against 2 * (2 * C + NH) + 4 bytes; at C = 80, NH = 128 that
// is 369 KFLOP against 0.6 KB. Blocks of one pixel tile that differ in the
// channel tile are neighbours in the grid, so actv comes from device memory
// once and from L2 after.
//
// Rounding follows the plain PyTorch version (modulate_ref in
// ops/spade_fused.py): every intermediate it holds in the compute dtype is
// rounded through T here (rt<T>); accumulation and the normalisation are f32.
// float32 inputs take plain FMA loops (exact in f32, slow).
//
// Below the modulation kernels, the one-pass instance statistics (a helper of
// both SPADE kernels).
//
// Plain C interface for ctypes; the entry points return cudaGetLastError().

#include "conv_tile.cuh"

using namespace hv;

namespace {

constexpr int MOD_KC = 32;           // actv channels per chunk
constexpr int MOD_CT = 32;           // x channels per block

struct ModParams {
  const void* x;        // (B, H, W, C)
  const float* noise;   // (B, H, W)
  const float* nscale;  // (C)
  const float* mu;      // (B, C)
  const float* rsig;    // (B, C)
  const void* actv;     // (B, H, W, NH), pre-relu
  const void* wk;       // packed gamma|beta weights (see the entry points)
  const float* bgb;     // (2, CP): gamma bias, beta bias, rounded through the dtype
  void* out;            // (B, H, W, C)
  int B, H, W, C, NH, CP;
};

__global__ void __launch_bounds__(CT_NT, 2)
spade_modulate_tc_kernel(const ModParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nct = p.CP / MOD_CT;
  const int ct = blockIdx.x % nct, tx = blockIdx.x / nct;
  const int b = blockIdx.z, y0 = blockIdx.y * CT_TH, x0 = tx * CT_TW;
  // columns [64 ct, 64 ct + 32): gamma of channels [32 ct, 32 ct + 32); the
  // next 32: their beta. acc[r][j] and acc[r][j + 4] belong together.
  float acc[2][8][4] = {};
  conv_mainloop_tc<4>(acc, static_cast<const bf*>(p.actv), p.H, p.W, p.NH,
                      static_cast<const bf*>(p.wk), MOD_KC, p.NH / MOD_KC, 2 * p.CP,
                      ct * 2 * MOD_CT, /*relu*/ 1, b, y0, x0,
                      reinterpret_cast<bf*>(smem_raw));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf* x = static_cast<const bf*>(p.x);
  bf* out = static_cast<bf*>(p.out);
  const float* mu = p.mu + b * p.C;
  const float* rsig = p.rsig + b * p.C;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gy = y0 + 2 * warp + r;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + g + 8 * half;
      if (gy >= p.H || gx >= p.W) continue;
      const size_t pix = (size_t)(b * p.H + gy) * p.W + gx;
      const float nz = p.noise[pix];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = ct * MOD_CT + j * 8 + 2 * t;     // C is even: c and c + 1, or neither
        if (c >= p.C) continue;
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + pix * p.C + c));
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = c + e;
          const float gm = rt<bf>(rt<bf>(acc[r][j][2 * half + e]) + __ldg(p.bgb + cc));
          const float be =
              rt<bf>(rt<bf>(acc[r][j + 4][2 * half + e]) + __ldg(p.bgb + p.CP + cc));
          const float xn = rt<bf>((e ? xv.y : xv.x) + rt<bf>(nz * __ldg(p.nscale + cc)));
          const float nrm = rt<bf>((xn - __ldg(mu + cc)) * __ldg(rsig + cc));
          o[e] = rt<bf>(rt<bf>(nrm * rt<bf>(1.f + gm)) + be);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + pix * p.C + c) =
            __floats2bfloat162_rn(o[0], o[1]);
      }
    }
  }
}

// float32: warp = tile row, lane = channel; gamma and beta columns side by side.
__global__ void __launch_bounds__(CT_NT)
spade_modulate_f32_kernel(const ModParams p) {
  __shared__ __align__(16) float A[CF_SMEM_FLOATS];
  const int nct = p.CP / 32;
  const int ct = blockIdx.x % nct, tx = blockIdx.x / nct;
  const int b = blockIdx.z, y0 = blockIdx.y * CF_TH, x0 = tx * CF_TW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = ct * 32 + lane;
  const int col[2] = {c, p.CP + c};
  float acc[2][CF_TW] = {};
  conv_mainloop_f32<2>(acc, static_cast<const float*>(p.actv), p.H, p.W, p.NH,
                       static_cast<const float*>(p.wk), p.NH, 2 * p.CP, col, /*relu*/ 1, b,
                       y0, x0, A);
  const int gy = y0 + warp;
  if (c >= p.C || gy >= p.H) return;
  const float* x = static_cast<const float*>(p.x);
  float* out = static_cast<float*>(p.out);
  const float bg = p.bgb[c], bb = p.bgb[p.CP + c], nsc = p.nscale[c];
  const float muc = p.mu[b * p.C + c], rsc = p.rsig[b * p.C + c];
#pragma unroll
  for (int j = 0; j < CF_TW; ++j) {
    const int gx = x0 + j;
    if (gx >= p.W) continue;
    const size_t pix = (size_t)(b * p.H + gy) * p.W + gx;
    const float xn = x[pix * p.C + c] + p.noise[pix] * nsc;
    const float nrm = (xn - muc) * rsc;
    out[pix * p.C + c] = nrm * (1.f + (acc[0][j] + bg)) + (acc[1][j] + bb);
  }
}

ModParams make_params(const void* x, const void* noise, const void* nscale, const void* mu,
                      const void* rsig, const void* actv, const void* wk, const void* bgb,
                      void* out, int B, int H, int W, int C, int NH, int CP) {
  ModParams p;
  p.x = x; p.noise = static_cast<const float*>(noise);
  p.nscale = static_cast<const float*>(nscale);
  p.mu = static_cast<const float*>(mu); p.rsig = static_cast<const float*>(rsig);
  p.actv = actv; p.wk = wk; p.bgb = static_cast<const float*>(bgb); p.out = out;
  p.B = B; p.H = H; p.W = W; p.C = C; p.NH = NH; p.CP = CP;
  return p;
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
template <> __device__ __forceinline__ float xn_value<float>(float x, float nz, float nsc) {
  return x + __fmul_rn(nz, nsc);
}
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

// bfloat16: C even, NH % 32 == 0, CP = C padded to 32. wk: (NH / 32, 9 * 32,
// 2 * CP) bf16 K x N; of each 64 columns the first 32 are gamma's and the
// last 32 beta's of the same channels (zeros past C). bgb: (2, CP) f32.
int spade_modulate_forward_bf16(const void* x, const void* noise, const void* nscale,
                                const void* mu, const void* rsig, const void* actv,
                                const void* wk, const void* bgb, void* out, int B, int H,
                                int W, int C, int NH, int CP, void* stream) {
  if (C <= 0 || C % 2 || NH <= 0 || NH % MOD_KC || CP % MOD_CT || CP < C)
    return (int)cudaErrorInvalidValue;
  const ModParams p = make_params(x, noise, nscale, mu, rsig, actv, wk, bgb, out, B, H, W,
                                  C, NH, CP);
  const size_t smem = ct_smem_bytes(MOD_KC, 2 * MOD_CT);
  cudaError_t err = cudaFuncSetAttribute(
      spade_modulate_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + CT_TW - 1) / CT_TW * (CP / MOD_CT), (H + CT_TH - 1) / CT_TH, B);
  spade_modulate_tc_kernel<<<grid, CT_NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// float32: NH % 32 == 0, CP = C padded to 32. wk: (9, NH, 2 * CP) f32, gamma
// in columns [0, CP), beta in [CP, 2 CP). bgb: (2, CP) f32.
int spade_modulate_forward_f32(const void* x, const void* noise, const void* nscale,
                               const void* mu, const void* rsig, const void* actv,
                               const void* wk, const void* bgb, void* out, int B, int H,
                               int W, int C, int NH, int CP, void* stream) {
  if (C <= 0 || NH <= 0 || NH % CF_KC || CP % 32 || CP < C) return (int)cudaErrorInvalidValue;
  const ModParams p = make_params(x, noise, nscale, mu, rsig, actv, wk, bgb, out, B, H, W,
                                  C, NH, CP);
  dim3 grid((W + CF_TW - 1) / CF_TW * (CP / 32), (H + CF_TH - 1) / CF_TH, B);
  spade_modulate_f32_kernel<<<grid, CT_NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The instance statistics. x: (B, HW, C) bf16 (bf16 = 1) or f32, contiguous,
// 16-byte aligned; noise: (B, HW) f32; nscale: (C) f32; ws: (B, S, C, 2) f64
// scratch; mu, rsig: (B, C) f32. S: chunks of pixels per image (one block
// each). C <= 2048.
int instance_stats_forward(const void* x, const void* noise, const void* nscale, void* ws,
                           void* mu, void* rsig, int B, int HW, int C, int S, int bf16,
                           float eps, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || (C + 7) / 8 > ST_NT || S <= 0 || S > HW)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(S, B);
  const int chunk = (HW + S - 1) / S;
  const float* nz = static_cast<const float*>(noise);
  const float* nsc = static_cast<const float*>(nscale);
  double* w = static_cast<double*>(ws);
  if (bf16)
    instance_stats_partial_kernel<__nv_bfloat16><<<grid, ST_NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), nz, nsc, w, HW, C, chunk);
  else
    instance_stats_partial_kernel<float><<<grid, ST_NT, 0, s>>>(static_cast<const float*>(x),
                                                                  nz, nsc, w, HW, C, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  instance_stats_finalize_kernel<<<B, ST_NT, 0, s>>>(w, static_cast<float*>(mu),
                                                     static_cast<float*>(rsig), HW, C, S, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
