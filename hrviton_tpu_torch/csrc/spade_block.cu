// Fused {SPADE-norm -> activation -> consumer conv} unit for Hopper (sm_90a).
//
// Replaces the TPU kernel hrviton_tpu/ops/spade_block.py:_kernel (reached
// through fused_spade_conv, whose pl.pallas_call is at spade_block.py:337).
// One launch computes, for one {SPADENorm, conv} pair of a SPADEResBlock:
//
//   xn   = x + noise * nscale
//   norm = (xn - mu) * rsig                      (mu, rsig: f32 instance stats)
//   g|b  = conv3x3(relu(actv), Wg|Wb) + bg|bb    (f32 accumulation)
//   mod  = act(norm * (1 + g) + b)               act: none | relu | leaky 0.2
//   out  = conv(mod, Wc) + bc [+ residual]       3x3 pad 1, or 1x1
//
// gamma, beta and mod never touch device memory: each thread block owns a
// TH x TW output tile with all cout channels, stages the relu(actv) halo
// ((TH+2r+2) x (TW+2r+2) x NH, zeros outside the image: the gamma/beta conv's
// padding) in shared memory, computes mod on the (TH+2r) x (TW+2r) halo into
// shared memory (zeros outside the image: the consumer conv's padding,
// applied after the activation), then runs the consumer conv from shared
// memory and adds the bias and the residual.
//
// What bounds it on this card: at 1024x768 the six units of the generator's
// up_3/up_4 blocks do ~1.12 TFLOP per image against ~1.5 GB of compulsory
// traffic, so the work is compute-bound (bf16 tensor-core bound ~1.1 ms per
// image at 989 TFLOP/s). Two versions share the tile plan:
//   * bfloat16 (the main path): both products on the tensor cores
//     (mma.sync, ldmatrix, weights staged by cp.async; spade_unit_tc_kernel);
//   * float32: plain FMA loops from shared memory (spade_unit_kernel),
//     exact in f32 and slow.
// Both pay for the gamma/beta halo recompute of 3x3 consumers
// ((TH+2)(TW+2)/(TH*TW): 1.56x at 8x8 for f32, 1.52x at 6x14 for bf16).
//
// Rounding follows the plain PyTorch version (spade_conv_ref in
// ops/spade_block.py): every intermediate that the plain version holds in
// the compute dtype is rounded through T here (rt<T>), accumulations are f32.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError().

#include "mma_utils.cuh"

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
// bf16 tensor-core version (the main path's dtype). Same fusion; both
// products run as mma.sync m16n8k16 bf16 tensor-core ops with f32
// accumulators, operands fed by ldmatrix:
//   gamma|beta: M = mod-halo pixels (one 16-pixel M tile per halo row),
//               N = gamma and beta channels, K = 9 taps x NH;
//   consumer:   M = output pixels (16 per row; TW valid), N = COUTP,
//               K = KS*KS taps x CP.
// A comes from shared memory (the relu(actv) halo, then the mod halo). B
// (the weights) is staged through shared memory in chunks by cp.async,
// double-buffered, and shared by all warps of the block: gamma|beta runs in
// passes of two 16-channel tiles (64 B columns: gamma, beta of each tile),
// each warp owning one tile of the pass and MH/4 halo rows. Shared-memory row
// strides are 16 mod 128 bytes, so ldmatrix reads are free of bank conflicts.
// Accumulators go through a per-warp shared staging tile for the
// elementwise epilogues.
// An M tile must be 16 consecutive pixels of one row, so the mod halo is
// exactly 16 wide: TW = 14 output columns for the 3x3 consumer, 16 for 1x1.

constexpr int TC_MH = 8;                    // mod-halo rows per block
constexpr int TC_KCH = 64;                  // K rows per staged gamma|beta chunk
constexpr int TC_LDB = 72;                  // its smem row stride (64 + 8 pad)
constexpr int TC_MINB = 2;                  // blocks per SM (registers, smem)

template <int KS> struct TcGeom {
  static constexpr int R = KS / 2;
  static constexpr int MH = TC_MH;            // mod-halo rows (= M tiles)
  static constexpr int TH = MH - 2 * R;       // output rows per block
  static constexpr int TW = 16 - 2 * R;       // output columns per block
  static constexpr int MWS = 16 + 2 * R;      // mod smem row width (cols >= 16 zero)
  static constexpr int AH = MH + 2;           // relu(actv) halo rows
  static constexpr int AW = 18;               // relu(actv) halo columns
  static constexpr int RPW = MH / 4;          // halo rows per warp (gamma|beta)
  static constexpr int CU = (TH * 4 + NWARP - 1) / NWARP;  // consumer frags/warp
};

struct TcParams {
  const __nv_bfloat16* x;      // (B, H, W, C)
  const float* noise;          // (B, H, W)
  const float* nscale;         // (C)
  const float* mu;             // (B, C)
  const float* rsig;           // (B, C)
  const __nv_bfloat16* actv;   // (B, H, W, NH), pre-relu
  const __nv_bfloat16* wgb;    // (NPASS, 9*NH, 64): per pass [g t | b t | g t+1 | b t+1]
  const float* bgb;            // (2, CP), rounded through bf16
  const __nv_bfloat16* wc;     // (KS*KS, CP, COUTP) K x N
  const float* bc;             // (COUTP), rounded through bf16
  const __nv_bfloat16* res;    // (B, H, W, COUT) or null
  __nv_bfloat16* out;          // (B, H, W, COUT)
  int B, H, W, C, NH, COUT, CP, COUTP, AS, CS, pre_act;
  // CP: C padded to 16; AS = NH + 8 and CS = CP + 8: smem row strides of
  // 16 mod 128 bytes, so the 8 rows of an ldmatrix phase hit distinct banks
};

// a 16x16 f32 accumulator (two m16n8 halves) -> row-major staging tile
__device__ __forceinline__ void stage16x16(float* st, float (*acc)[4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    *reinterpret_cast<float2*>(st + g * 16 + h * 8 + 2 * t) = make_float2(acc[h][0], acc[h][1]);
    *reinterpret_cast<float2*>(st + (g + 8) * 16 + h * 8 + 2 * t) =
        make_float2(acc[h][2], acc[h][3]);
  }
}

template <int KS>
__global__ void __launch_bounds__(NT, TC_MINB)
spade_unit_tc_kernel(const TcParams p) {
  using G = TcGeom<KS>;
  typedef __nv_bfloat16 bf;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf* A = reinterpret_cast<bf*>(smem_raw);            // AH*AW*AS; later consumer B
  bf* M = A + G::AH * G::AW * p.AS;                   // MH*MWS*CS
  bf* Bs = M + G::MH * G::MWS * p.CS;                 // 2 x TC_KCH x TC_LDB
  float* st = reinterpret_cast<float*>(Bs) + (threadIdx.x >> 5) * 512;  // epilogues

  const int H = p.H, W = p.W, C = p.C, NH = p.NH, CP = p.CP;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * G::TH, x0 = blockIdx.x * G::TW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // gamma|beta weights arrive in chunks; the first flies during step 1
  const int ctiles = CP / 16;
  const int npass = (ctiles + 1) / 2;
  const int nq = 9 * NH / TC_KCH;                     // chunks per pass
  auto load_chunk = [&](int pass, int q, int buf) {
    const bf* src = p.wgb + ((size_t)pass * 9 * NH + (size_t)q * TC_KCH) * 64;
    bf* dst = Bs + buf * TC_KCH * TC_LDB;
    for (int i = tid; i < TC_KCH * 8; i += NT)
      cp_async16(dst + (i >> 3) * TC_LDB + (i & 7) * 8, src + (i >> 3) * 64 + (i & 7) * 8);
    cp_async_commit();
  };
  load_chunk(0, 0, 0);

  // ---- 1. relu(actv) halo -> A, zeroed mod halo -> M --------------------
  const int n8 = NH / 8;
  for (int i = tid; i < G::AH * G::AW * n8; i += NT) {
    const int q = i % n8, pix = i / n8;
    const int gy = y0 - G::R - 1 + pix / G::AW, gx = x0 - G::R - 1 + pix % G::AW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = *reinterpret_cast<const uint4*>(
          p.actv + ((size_t)(b * H + gy) * W + gx) * NH + q * 8);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
      const __nv_bfloat162 z = __float2bfloat162_rn(0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) h2[e] = __hmax2(h2[e], z);
    }
    *reinterpret_cast<uint4*>(A + (size_t)pix * p.AS + q * 8) = v;
  }
  for (int i = tid; i < G::MH * G::MWS * p.CS / 8; i += NT)
    reinterpret_cast<uint4*>(M)[i] = make_uint4(0, 0, 0, 0);

  // ---- 2. gamma|beta (mma), modulate, activate -> M ---------------------
  const int tl = warp & 1;                            // my tile of the pass
  const int rbase = warp >> 1;                        // my rows: rbase + 4i
  // epilogue lanes: one pixel of the 16-pixel row, 8 of the tile's channels
  const int epx = lane >> 1, ecl = (lane & 1) * 8;
  for (int pass = 0; pass < npass; ++pass) {
    const int j = 2 * pass + tl;
    float acc[G::RPW][2][2][4] = {};        // [row][gamma|beta][n8 half][4]
    if (pass > 0) load_chunk(pass, 0, 0);
    for (int q = 0; q < nq; ++q) {
      if (q + 1 < nq) {
        load_chunk(pass, q + 1, (q + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (j < ctiles) {
        // B: rows k of the chunk, this warp's 32 columns [gamma 16 | beta 16]
        const bf* bsrc = Bs + (q & 1) * TC_KCH * TC_LDB + (lane & 15) * TC_LDB +
                         tl * 32 + (lane >> 4) * 8;
        const int kg = q * TC_KCH;
        const int tap = kg / NH, kb = kg % NH;
        // A: 16 pixels of a halo row (one per lane % 16), k-half by lane / 16
        const bf* abase = A + ((size_t)(rbase + tap / 3) * G::AW + tap % 3 + (lane & 15)) * p.AS +
                          kb + (lane >> 4) * 8;
#pragma unroll
        for (int kk = 0; kk < TC_KCH; kk += 16) {
          unsigned bg[4], bb[4];
          ldsm_x4_t(bg, bsrc + kk * TC_LDB);
          ldsm_x4_t(bb, bsrc + kk * TC_LDB + 16);
#pragma unroll
          for (int i = 0; i < G::RPW; ++i) {
            unsigned a[4];
            ldsm_x4(a, abase + (size_t)i * 4 * G::AW * p.AS + kk);
            mma_bf16(acc[i][0][0], a, bg[0], bg[1]);
            mma_bf16(acc[i][0][1], a, bg[2], bg[3]);
            mma_bf16(acc[i][1][0], a, bb[0], bb[1]);
            mma_bf16(acc[i][1][1], a, bb[2], bb[3]);
          }
        }
      }
      __syncthreads();          // buffer q & 1 is free for chunk q + 2
    }
    if (j < ctiles) {           // epilogue; Bs doubles as the staging tiles
#pragma unroll
      for (int i = 0; i < G::RPW; ++i) {
        const int row = rbase + 4 * i;
        stage16x16(st, acc[i][0], lane);
        stage16x16(st + 256, acc[i][1], lane);
        __syncwarp();
        const int gy = y0 - G::R + row, gx = x0 - G::R + epx;
        const int c0 = j * 16 + ecl;                   // C % 8 == 0: all or none
        float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (c0 < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const size_t pix = (size_t)(b * H + gy) * W + gx;
          float xv[8], nsc[8], mu[8], rs[8], bg[8], bb[8], g[8], bt[8];
          load8(p.x + pix * C + c0, xv);
          load8(p.nscale + c0, nsc);
          load8(p.mu + b * C + c0, mu);
          load8(p.rsig + b * C + c0, rs);
          load8(p.bgb + c0, bg);
          load8(p.bgb + CP + c0, bb);
          load8(st + epx * 16 + ecl, g);
          load8(st + 256 + epx * 16 + ecl, bt);
          const float nz = p.noise[pix];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float xn = rt<bf>(xv[k] + rt<bf>(nz * nsc[k]));
            const float nrm = rt<bf>((xn - mu[k]) * rs[k]);
            const float gm = rt<bf>(rt<bf>(g[k]) + bg[k]);
            const float be = rt<bf>(rt<bf>(bt[k]) + bb[k]);
            m[k] = pre_activate<bf>(rt<bf>(rt<bf>(nrm * rt<bf>(1.f + gm)) + be), p.pre_act);
          }
        }
        store8(M + ((size_t)row * G::MWS + epx) * p.CS + c0, m);
        __syncwarp();
      }
    }
    __syncthreads();            // staging done before the next pass's chunks
  }

  // ---- 3. consumer conv (mma) from M, + bias [+ residual] -> out ---------
  // the relu(actv) halo is dead: its space stages the consumer weights, one
  // tap (CP x COUTP) at a time, double-buffered; units = (row, 16-ch tile)
  const int ntl = p.COUTP / 16;
  const int units = G::TH * ntl;
  const int ldc = p.COUTP + 8;
  bf* Ws = A;
  auto load_tap = [&](int tap, int buf) {
    const bf* src = p.wc + (size_t)tap * CP * p.COUTP;
    bf* dst = Ws + buf * CP * ldc;
    const int segs = p.COUTP / 8;
    for (int i = tid; i < CP * segs; i += NT)
      cp_async16(dst + (i / segs) * ldc + (i % segs) * 8, src + (i / segs) * p.COUTP + (i % segs) * 8);
    cp_async_commit();
  };
  float acc[G::CU][2][4] = {};
  load_tap(0, 0);
  for (int tap = 0; tap < KS * KS; ++tap) {
    if (tap + 1 < KS * KS) {
      load_tap(tap + 1, (tap + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf* wsrc = Ws + (tap & 1) * CP * ldc + (lane & 15) * ldc + (lane >> 4) * 8;
    const bf* mt = M + ((size_t)(tap / KS) * G::MWS + tap % KS + (lane & 15)) * p.CS +
                   (lane >> 4) * 8;
    for (int c0 = 0; c0 < CP; c0 += 16) {
#pragma unroll
      for (int i = 0; i < G::CU; ++i) {
        const int u = warp + NWARP * i;
        if (u < units) {
          const int oy = u / ntl, nt = u % ntl;
          unsigned a[4], w[4];
          ldsm_x4(a, mt + (size_t)oy * G::MWS * p.CS + c0);
          ldsm_x4_t(w, wsrc + c0 * ldc + nt * 16);
          mma_bf16(acc[i][0], a, w[0], w[1]);
          mma_bf16(acc[i][1], a, w[2], w[3]);
        }
      }
    }
    __syncthreads();            // buffer tap & 1 is free for tap + 2
  }
#pragma unroll
  for (int i = 0; i < G::CU; ++i) {
    const int u = warp + NWARP * i;
    if (u < units) {
      const int oy = u / ntl, nt = u % ntl;
      stage16x16(st, acc[i], lane);
      __syncwarp();
      const int gy = y0 + oy, gx = x0 + epx;
      const int co0 = nt * 16 + ecl;                   // COUT % 8 == 0
      if (epx < G::TW && gy < H && gx < W && co0 < p.COUT) {
        const size_t idx = ((size_t)(b * H + gy) * W + gx) * p.COUT + co0;
        float a[8], bcv[8], v[8];
        load8(st + epx * 16 + ecl, a);
        load8(p.bc + co0, bcv);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = rt<bf>(rt<bf>(a[k]) + bcv[k]);
        if (p.res != nullptr) {
          float r[8];
          load8(p.res + idx, r);
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = rt<bf>(v[k] + r[k]);
        }
        store8(p.out + idx, v);
      }
      __syncwarp();
    }
  }
}

template <int KS>
size_t tc_smem_bytes(int nh, int cs) {
  using G = TcGeom<KS>;
  return (size_t)G::AH * G::AW * (nh + 8) * 2 + (size_t)G::MH * G::MWS * cs * 2 +
         (size_t)2 * TC_KCH * TC_LDB * 2;
}

// The consumer's weight stage (2 x CP x (COUTP + 8)) reuses the actv halo.
template <int KS>
bool tc_fits(int nh, int cp, int coutp) {
  using G = TcGeom<KS>;
  return 2 * cp * (coutp + 8) <= G::AH * G::AW * (nh + 8) &&
         coutp / 16 * G::TH <= G::CU * NWARP;
}

template <int KS>
cudaError_t launch_tc(const TcParams& p, cudaStream_t stream) {
  using G = TcGeom<KS>;
  if (!tc_fits<KS>(p.NH, p.CP, p.COUTP)) return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes<KS>(p.NH, p.CS);
  cudaError_t err = cudaFuncSetAttribute(spade_unit_tc_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.W + G::TW - 1) / G::TW, (p.H + G::TH - 1) / G::TH, p.B);
  spade_unit_tc_kernel<KS><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of the bf16 launch, or 0 for a shape it does not take.
size_t spade_unit_tc_smem_bytes(int ks, int nh, int cp, int coutp, int cs) {
  if (nh % TC_KCH || cp % 16 || coutp % 16 || cs < cp || cs % 8) return 0;
  if (ks == 3) return tc_fits<3>(nh, cp, coutp) ? tc_smem_bytes<3>(nh, cs) : 0;
  if (ks == 1) return tc_fits<1>(nh, cp, coutp) ? tc_smem_bytes<1>(nh, cs) : 0;
  return 0;
}

// bfloat16 only, C and COUT multiples of 8. Layouts as in TcParams; cs is
// the mod-halo channel stride (CP + 8).
int spade_unit_forward_bf16(const void* x, const void* noise, const void* nscale,
                            const void* mu, const void* rsig, const void* actv,
                            const void* wgb, const void* bgb, const void* wc,
                            const void* bc, const void* res, void* out,
                            int B, int H, int W, int C, int NH, int COUT, int CP,
                            int COUTP, int CS, int ks, int pre_act, void* stream) {
  if (spade_unit_tc_smem_bytes(ks, NH, CP, COUTP, CS) == 0 || C % 8 || COUT % 8)
    return (int)cudaErrorInvalidValue;
  TcParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.noise = static_cast<const float*>(noise);
  p.nscale = static_cast<const float*>(nscale);
  p.mu = static_cast<const float*>(mu); p.rsig = static_cast<const float*>(rsig);
  p.actv = static_cast<const __nv_bfloat16*>(actv);
  p.wgb = static_cast<const __nv_bfloat16*>(wgb);
  p.bgb = static_cast<const float*>(bgb);
  p.wc = static_cast<const __nv_bfloat16*>(wc);
  p.bc = static_cast<const float*>(bc);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B; p.H = H; p.W = W; p.C = C; p.NH = NH; p.COUT = COUT;
  p.CP = CP; p.COUTP = COUTP; p.AS = NH + 8; p.CS = CS; p.pre_act = pre_act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(ks == 3 ? launch_tc<3>(p, s) : launch_tc<1>(p, s));
}

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
