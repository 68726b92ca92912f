// The SPADE modulation as the epilogue of the conv engine's gamma|beta
// product (conv_engine.cuh): stage (a) of the fused unit (spade_block.cu,
// with the unit's activation) and the whole of the fused modulation
// (spade_fused.cu, with none). For one SPADENorm:
//
//   xn   = x + noise * nscale
//   norm = (xn - mu) * rsig                      (mu, rsig: f32 instance stats)
//   g|b  = conv3x3(relu(actv), Wg|Wb) + bg|bb    (f32 accumulation)
//   out  = act(norm * (1 + g) + b)               act: none | relu | leaky 0.2
//
// M = pixels, K = 9 x NH of the relu'd actv halo (relu is the engine's
// transform on A), N = 2 C: gamma and beta columns interleaved in groups of 8
// (ops/spade_fused.py:pack_gb), so that gamma[c] and beta[c] of a pixel sit
// in one thread. Each intermediate is rounded as the plain versions round it
// (modulate_ref, gamma_beta_stage_ref), in bf16x2 arithmetic.
//
// What the epilogue reads: x and the noise of the tile while its last
// products run (load), and five per-channel constants (nscale, mu[b],
// rsig[b] and the two biases), which are fixed for a block (its image and N
// tile do not change): prepare() stages them in shared memory once per
// block, a 32-byte record per channel pair, so that apply() reads two
// 16-byte words per group of 8 channels where it made five loads.
#pragma once

#include "conv_engine.cuh"

namespace hv {

// The epilogue's knock mask bits (timing only; the JAX unit's "normalize"
// and "modulate", hrviton_tpu/ops/spade_block.py:209-215), beside the
// engine's (conv_engine.cuh): norm = xn; mod = norm + g.
constexpr int KNOCK_NORMALIZE = 8, KNOCK_MODULATE = 16;

// Two neighbouring channels of mod, each rounded as the plain version rounds
// it, in bf16x2 arithmetic: an add or a multiply of two bf16 values rounds the
// exact result once, which is what the plain version's f32 operation followed
// by its rounding to bf16 gives. g and bt are the f32 accumulators of gamma
// and beta. KNOCK: the epilogue's knock bits (0 in production).
template <int KNOCK = 0>
__device__ __forceinline__ __nv_bfloat162 modulate2(__nv_bfloat162 x, float nz, float2 nsc,
                                                    float2 mu, float2 rs, float g0, float g1,
                                                    float b0, float b1, __nv_bfloat162 bg,
                                                    __nv_bfloat162 bb, int pre_act) {
  const __nv_bfloat162 one = __float2bfloat162_rn(1.f);
  const __nv_bfloat162 xn = __hadd2(x, __floats2bfloat162_rn(nz * nsc.x, nz * nsc.y));
  const float2 xf = __bfloat1622float2(xn);
  __nv_bfloat162 nrm;
  if constexpr ((KNOCK & KNOCK_NORMALIZE) != 0)
    nrm = xn;
  else
    nrm = __floats2bfloat162_rn((xf.x - mu.x) * rs.x, (xf.y - mu.y) * rs.y);
  const __nv_bfloat162 gm = __hadd2(__floats2bfloat162_rn(g0, g1), bg);
  __nv_bfloat162 m;
  if constexpr ((KNOCK & KNOCK_MODULATE) != 0) {
    m = __hadd2(nrm, gm);
  } else {
    const __nv_bfloat162 be = __hadd2(__floats2bfloat162_rn(b0, b1), bb);
    m = __hadd2(__hmul2(nrm, __hadd2(one, gm)), be);
  }
  if (pre_act == 1) m = __hmax2(m, __float2bfloat162_rn(0.f));
  if (pre_act == 2) m = __hmax2(m, __hmul2(m, __float2bfloat162_rn(0.2f)));
  return m;
}

// The epilogue. Column group 2 i of an N tile holds gamma of the channels c0
// + 8 i .. + 7 (c0 = ntile * CT), group 2 i + 1 beta of the same.
struct ModEpilogue {
  __nv_bfloat16* out;          // (B, H, W, C): act(mod)
  const __nv_bfloat16* x;      // (B, H, W, C)
  const float* noise;          // (B, H, W)
  const float* nscale;         // (C)
  const float* mu;             // (B, C)
  const float* rsig;           // (B, C)
  const float* bgb;            // (2, C): gamma's and beta's bias, rounded through bf16
  int H, W, C, CT, pre_act;    // CT: channels of an N tile (BN / 2)

  template <int BN> struct Pre {
    __nv_bfloat162 x[2][BN / 16];
    float nz[2];
  };

  // channels c, c + 1 of the block's image; the biases as bf16x2 bits
  struct Pair {
    float2 ns, mu, rs;
    unsigned bg, bb;
  };
  template <int BN> struct Shared {
    Pair p[BN / 4];            // the N tile's CT / 2 channel pairs
  };

  template <int BN>
  __device__ __forceinline__ void prepare(Shared<BN>& s, int b, int ntile, int tid) const {
    for (int k = tid; k < BN / 4; k += engine::CONSUMERS) {
      const int c = min(ntile * CT + 2 * k, C - 2);   // past C: computed, not stored
      const float2 bg = engine::ld2(bgb + c), bb = engine::ld2(bgb + C + c);
      s.p[k] = Pair{engine::ld2(nscale + c), engine::ld2(mu + b * C + c),
                    engine::ld2(rsig + b * C + c), engine::pack2(bg.x, bg.y),
                    engine::pack2(bb.x, bb.y)};
    }
  }

  template <int BN>
  __device__ __forceinline__ Pre<BN> load(int b, int y, int x0, int ntile, int lane,
                                          int w4) const {
    const int g = lane >> 2, t = lane & 3, c0 = ntile * CT, px = x0 + g;
    Pre<BN> p;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int py = y + 2 * w4 + half;
      const bool ok = py < H && px < W;
      const size_t pix = ok ? (size_t)(b * H + py) * W + px : 0;
      p.nz[half] = ok ? __ldg(noise + pix) : 0.f;
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        const int c = c0 + 8 * i + 2 * t;
        p.x[half][i] = ok && c < C
                           ? __ldg(reinterpret_cast<const __nv_bfloat162*>(x + pix * C + c))
                           : __float2bfloat162_rn(0.f);
      }
    }
    return p;
  }

  template <int BN>
  __device__ __forceinline__ void apply(const float (&d)[BN / 2], const Pre<BN>& p,
                                        const Shared<BN>& s, int b, int y, int x0, int ntile,
                                        int lane, int w4) const {
    apply_knocked<BN, 0>(d, p, s, b, y, x0, ntile, lane, w4);
  }

  template <int BN, int KNOCK>
  __device__ __forceinline__ void apply_knocked(const float (&d)[BN / 2], const Pre<BN>& p,
                                                const Shared<BN>& s, int b, int y, int x0,
                                                int ntile, int lane, int w4) const {
    constexpr int G = BN / 16;
    const int g = lane >> 2, t = lane & 3, c0 = ntile * CT, px = x0 + g;
    unsigned w[2][G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const Pair k = s.p[4 * i + t];
      const __nv_bfloat162 bg = *reinterpret_cast<const __nv_bfloat162*>(&k.bg);
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(&k.bb);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 v =
            modulate2<KNOCK>(p.x[half][i], p.nz[half], k.ns, k.mu, k.rs, d[8 * i + 2 * half],
                      d[8 * i + 2 * half + 1], d[8 * i + 4 + 2 * half],
                      d[8 * i + 4 + 2 * half + 1], bg, bb, pre_act);
        w[half][i] = *reinterpret_cast<const unsigned*>(&v);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int py = y + 2 * w4 + half;
      const bool ok = py < H && px < W;
      const size_t pix = ok ? (size_t)(b * H + py) * W + px : 0;
      engine::store_words<G>(out + pix * C, w[half], c0, C, ok, t);
    }
  }
};

// The epilogue of a knock variant of the unit's gamma|beta stage
// (spade_knock.cu): KNOCK's epilogue bits (KNOCK_NORMALIZE, KNOCK_MODULATE).
template <int KNOCK>
struct ModKnockEpilogue : ModEpilogue {
  template <int BN>
  __device__ __forceinline__ void apply(const float (&d)[BN / 2], const Pre<BN>& p,
                                        const Shared<BN>& s, int b, int y, int x0, int ntile,
                                        int lane, int w4) const {
    apply_knocked<BN, KNOCK>(d, p, s, b, y, x0, ntile, lane, w4);
  }
};

}  // namespace hv
