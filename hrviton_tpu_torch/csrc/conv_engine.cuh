// One TMA / wgmma convolution engine for the model's kernels on Hopper
// (sm_90a): a KS x KS stride-1 convolution (KS = 1 or 3, zero padding KS / 2)
// of an NHWC bf16 input, f32 accumulation, a transform on the input and an
// epilogue that each kernel chooses. It generalises the design of
// csrc/conv_tma.cu's conv_halo_tma_kernel and keeps its structure:
//
//   * a block = one producer warp + two consumer warpgroups; it owns TH = 8
//     rows x OC = 32 columns (four 8 x 8-pixel M tiles of 64 rows, two per
//     warpgroup) x BN output columns, and walks up to MAX_BANDS successive row
//     tiles of its column strip so that the ring does not drain between them;
//     the producer warp's warpgroup gives its registers to the consumers
//     (setmaxnreg: 40 a thread there, 232 here), since 2 x BN / 2 f32
//     accumulators a thread do not fit the 168 that an even split of the
//     register file leaves 384 threads;
//   * one stage = (row tile, 16 input channels): the halo tile, which arrives
//     by TMA from the unpadded input (the box's out-of-bounds fill is the zero
//     border, and the zero channels past C), and the taps' weights for those
//     channels, packed on the host so that a stage is one contiguous block
//     already in the 32-byte swizzled order (one bulk copy);
//   * a ring of stages on full / empty mbarriers; the products are
//     wgmma.mma_async m64nBNk16 with both operands in shared memory, the KS x
//     KS taps KS x KS windows of the one halo tile;
//   * stores of 16 bytes through a 4 x 4 word transpose inside each quad.
//
// What it adds to conv_halo's: any multiple of 16 of K (a chunk past C is
// zero-filled), 1 x 1 or 3 x 3 taps, an N tile BN (a multiple of 8, one of the
// Wgmma<N> of wgmma_ops.cuh) chosen per call with the weights' N zero-padded
// to whole tiles, a transform on A, an epilogue policy, and narrow inputs.
//
// The input's channel count is a multiple of 8 (a pixel is whole 16-byte
// rows of a 4-D box), or, for a narrow Cfg, below 15 and no multiple of 8 (9
// channels: an 18-byte pixel, which no 4-D box can address). A narrow stage
// reads the halo's rows as they lie in device memory, W * C elements each,
// by two boxes of a 3-D tensor map over (B, H, W * C) per stage (a box holds
// at most 256 elements, a halo row of 34 pixels up to 476 at C = 14); they
// start on the 16 bytes at or left of the halo's first element, what lies
// left of a row is zero-filled and what lies right of it is zeroed. The
// consumers then spread those rows into the 16-channel swizzled pixel rows
// of the A tile (channels past C zero) in the slot of the transform on A.
//
// The transform on A (0 none, 1 relu, 2 leaky 0.2 with the slope and the
// product rounded to bf16, as a bf16 tensor multiplied by 0.2 gives them) is
// applied to the halo tile in shared memory, in place, once per stage, after
// the full barrier and while the previous stage's products run; then each
// thread fences its generic writes against the asynchronous proxy before a
// named barrier. act(0) = 0, so the zero border stays zero. Each warpgroup
// transforms columns of its own, each column once: warpgroup 0 the 16 + 2 R
// that its windows read, warpgroup 1 the 16 after them. Warpgroup 1's
// windows also read warpgroup 0's last 2 R columns, so warpgroup 0 arrives,
// without waiting, on the stage slot's barrier (3 + slot) as soon as its
// columns are ready, and later meets only its own threads (barrier 2);
// warpgroup 1 waits on the slot's barrier. No byte is written while a
// product may read it, and neither warpgroup waits for the other's products
// (2% off the nine norms of the modulation against all 256 threads
// transforming the whole tile and meeting on one barrier, PERF.md §6). A
// barrier per slot: warpgroup 0 arrives on a slot's barrier again only after
// the slot was refilled, which needs warpgroup 1 to have released it, after
// its wait. In shared memory and not
// on register-A fragments because the tile is read by nine taps: one pass
// over its 12.8 KB a stage costs less than transforming every window's
// fragments nine times, and keeps one descriptor path for all operands.
// Elementwise, so the swizzle does not matter. The first stage of a block,
// and every narrow stage (spread by all 256 threads), end on a barrier of
// all consumers (barrier 1).
//
// The epilogue policy is a struct with three types and three device members
//   template <int BN> struct Pre;      // what it reads ahead (may be empty)
//   template <int BN> struct Shared;   // per-block constants in shared memory
//   template <int BN> void prepare(Shared<BN>& s, int b, int ntile, int tid) const;
//   template <int BN> Pre<BN> load(int b, int y, int x, int ntile, int lane,
//                                  int w4) const;
//   template <int BN> void apply(const float (&d)[BN / 2], const Pre<BN>& pre,
//                                const Shared<BN>& s, int b, int y, int x,
//                                int ntile, int lane, int w4) const;
// prepare() runs once per block on the consumers (image b and N tile fixed),
// before they meet on a named barrier; per M tile (8 x 8 pixels from row y,
// column x of image b): load() runs while the row tile's last products are in
// flight, so that the epilogue's reads from device memory overlap them;
// apply() then gets this thread's accumulators, keeps the rounding chain of
// its plain version and masks what lies past H, W and the output channels.
// store_words() below is the common store.
//
// Knocks (timing only; the JAX unit's `knock`, hrviton_tpu/ops/
// spade_block.py:105): Cfg's KNOCK mask compiles a variant that removes one
// stage of the engine, so that the time it saves is that stage's. 0 is the
// engine as above (the same type, the same code). KNOCK_NO_A: the input's
// TMA loads are not issued (the full barrier waits for the weights alone;
// the products read whatever the ring holds); KNOCK_NO_DOTS: no stage is
// loaded or multiplied, the producer does nothing and no barrier of the
// ring is waited on, and the epilogue runs on zero accumulators;
// KNOCK_NO_ROLLS: every tap's window starts at the kx = R column, so the
// products of one row's taps are summed at the same column.

#pragma once

#include "mma_utils.cuh"
#include "tma_wgmma.cuh"
#include "wgmma_ops.cuh"

namespace hv {
namespace engine {

constexpr int KC = 16;                 // input channels per stage: one wgmma K
constexpr int KROW = 2 * KC;           // bytes of a pixel's chunk: the swizzle width
constexpr int TH = 8;                  // rows of a row tile
constexpr int OC = 32;                 // columns of a block: four 8 x 8 tiles
constexpr int CONSUMER_WARPS = 8;      // two warpgroups, two M tiles each
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int NT = CONSUMERS + 128;    // and the producer's warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;   // 128 x 40 + 256 x 232 <= 64 K
constexpr int MAX_BANDS = 8;           // successive row tiles a block may walk
constexpr int SMEM_LIMIT = 232448;     // bytes of shared memory a block may use

constexpr int align_up(int v, int a) { return (v + a - 1) / a * a; }

// a Cfg's knock mask bits (above); the epilogues may use the bits from 8 on
constexpr int KNOCK_NO_A = 1, KNOCK_NO_DOTS = 2, KNOCK_NO_ROLLS = 4;

// What every launch of the engine is told.
struct Geometry {
  int H, W;       // the image (B is gridDim.z)
  int NCHUNKS;    // K chunks: the input's channels / 16, rounded up
  int NTILES;     // N tiles of BN columns
  int NBANDS;     // row tiles: H / TH rounded up
  int BANDS;      // row tiles a block walks
  int act;        // the transform on A
  int cin;        // a narrow input's channels
  int box;        // and the elements of each of its two boxes a row
};

template <int KS_, int BN_, bool NARROW_ = false, int MINB_ = 1, int KNOCK_ = 0>
struct Cfg {
  static constexpr int KS = KS_, BN = BN_, KNOCK = KNOCK_;
  static constexpr bool NARROW = NARROW_;
  // blocks an SM holds: with two, the consumers keep the even split of the
  // register file (no setmaxnreg: 85 a thread), for narrow N tiles
  static constexpr int MINB = MINB_;
  static constexpr int R = KS / 2, TAPS = KS * KS;
  // staged columns: OC + 2 for a 3 x 3 halo, rounded up so that a tile row's
  // pitch stays a multiple of the 256-byte swizzle pattern (one descriptor
  // spans an 8 x 8 tile: the next eight M rows are the next tile row)
  static constexpr int SC = KS == 3 ? OC + 8 : OC;
  static constexpr int COLS = OC + 2 * R;                 // the columns products read
  static constexpr int ROWS = TH + 2 * R;
  static constexpr int PITCH = SC * KROW;
  static constexpr int A_TX = ROWS * PITCH;               // bytes of a stage's box
  static constexpr int A_BYTES = align_up(A_TX, 1024);
  static constexpr int TAP_BYTES = BN * KROW;
  static constexpr int W_BYTES = TAPS * TAP_BYTES;        // a stage's weights
  // a narrow stage's rows as they arrive: two boxes of at most 256 elements
  static constexpr int RAW_BOX = ROWS * 256 * 2;
  static constexpr int RAW_OFF = align_up(A_BYTES + W_BYTES, 1024);
  static constexpr int STAGE_BYTES = align_up(NARROW ? RAW_OFF + 2 * RAW_BOX : RAW_OFF, 1024);
  // 2 KB stay free for the epilogue's per-block constants (static shared);
  // two blocks share the SM's 228 KB, 1 KB of each the system's
  static constexpr int BUDGET = MINB == 1 ? SMEM_LIMIT : 233472 / MINB - 1024;
  static constexpr int FIT = (BUDGET - 1024 - 256 - 2048) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 1024;
  static_assert(BN % 8 == 0 && BN <= 256, "a wgmma N");
  static_assert(STAGES >= 2, "a ring needs two stages");
  static_assert(3 + STAGES <= 16, "a named barrier per stage slot");
  static_assert(!NARROW || KS == 3, "narrow inputs are 3 x 3 convs");
  static_assert(MINB == 1 || BN <= 32, "two blocks an SM hold narrow N tiles only");
  static_assert(!NARROW || KNOCK == 0, "no knock variants of a narrow input");
};

// act(v) on 16 bytes of bf16 (8 values) in place.
__device__ __forceinline__ uint4 transform8(uint4 v, int act) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (act == 1) {
      h[e] = __hmax2(h[e], zero);
    } else {
      const float slope = __bfloat162float(__float2bfloat16_rn(0.2f));
      const float2 f = __bfloat1622float2(h[e]);
      h[e] = __hmax2(h[e], __floats2bfloat162_rn(f.x * slope, f.y * slope));
    }
  }
  return v;
}

// The producer's lane: one stage per (row tile, chunk), in the consumers' order.
template <class C>
__device__ __forceinline__ void produce(const CUtensorMap* tmx, const unsigned char* wk,
                                        const Geometry& g, unsigned base, unsigned full,
                                        unsigned empty, int x0, int ntile, int i0, int nb,
                                        int b) {
  if constexpr ((C::KNOCK & KNOCK_NO_DOTS) != 0) return;
  int st = 0;
  unsigned ph = 0;
  for (int band = i0; band < i0 + nb; ++band) {
    const int y = band * TH - C::R;
    for (int q = 0; q < g.NCHUNKS; ++q) {
      mbar_wait(empty + 8 * st, ph ^ 1);
      const unsigned bar = full + 8 * st, a = base + st * C::STAGE_BYTES;
      if constexpr (C::NARROW) {
        // the halo's rows from element (x0 - 1) C on, the boxes' start
        // rounded down to 16 bytes; the second box only where the row
        // reaches into it
        const int e0 = ((x0 - C::R) * g.cin) & ~7;
        const bool two = e0 + g.box < g.W * g.cin;
        mbar_expect_tx(bar, (two ? 2 : 1) * C::ROWS * g.box * 2 + C::W_BYTES);
        tma_load_3d(a + C::RAW_OFF, tmx, bar, e0, y, b);
        if (two) tma_load_3d(a + C::RAW_OFF + C::RAW_BOX, tmx, bar, e0 + g.box, y, b);
      } else if constexpr ((C::KNOCK & KNOCK_NO_A) != 0) {
        mbar_expect_tx(bar, C::W_BYTES);
      } else {
        mbar_expect_tx(bar, C::A_TX + C::W_BYTES);
        tma_load_4d(a, tmx, bar, q * KC, x0 - C::R, y, b);
      }
      bulk_load(a + C::A_BYTES, wk + ((size_t)q * g.NTILES + ntile) * C::W_BYTES, C::W_BYTES,
                bar);
      if (++st == C::STAGES) { st = 0; ph ^= 1; }
    }
  }
}

// A narrow stage's rows, spread into the A tile: pixel (r, col) of the halo
// (column x0 - 1 + col of the image) takes its C channels from elements d +
// col * C .. of row r, d = the halo's first element less the boxes' start
// (box 0 holds the first g.box elements, box 1 the rest; what lies right of
// the image's row is zero, whether or not box 1 was loaded) and zeros up to
// 16, transformed, in the 32-byte swizzled order (16-byte half h of a
// 32-byte row stored at h xor address bit 7, as the copy engine lays out a
// box of the wide path).
template <class C>
__device__ __forceinline__ void spread_stage(unsigned char* s, const Geometry& g, int x0,
                                             int tid) {
  const unsigned short* raw0 = reinterpret_cast<const unsigned short*>(s + C::RAW_OFF);
  const unsigned short* raw1 = raw0 + C::RAW_BOX / 2;
  const int e = (x0 - C::R) * g.cin, e0 = e & ~7;
  const int d = e - e0, lim = g.W * g.cin - e0;
  for (int i = tid; i < C::ROWS * C::COLS; i += CONSUMERS) {
    const int r = i / C::COLS, col = i % C::COLS;
    unsigned w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      unsigned v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 2 * k + h, el = d + col * g.cin + c;
        v[h] = c >= g.cin || el >= lim ? 0u
               : el < g.box            ? raw0[r * g.box + el]
                                       : raw1[r * g.box + el - g.box];
      }
      w[k] = v[0] | (v[1] << 16);
    }
    uint4 lo = make_uint4(w[0], w[1], w[2], w[3]), hi = make_uint4(w[4], w[5], w[6], w[7]);
    if (g.act) {
      lo = transform8(lo, g.act);
      hi = transform8(hi, g.act);
    }
    const int off = r * C::PITCH + col * KROW, sw = ((off >> 7) & 1) << 4;
    *reinterpret_cast<uint4*>(s + (off ^ sw)) = lo;
    *reinterpret_cast<uint4*>(s + ((off + 16) ^ sw)) = hi;
  }
}

// The transform on A of columns C0 .. C0 + NC - 1 of a stage's halo tile,
// by the 128 threads of one warpgroup (t: the thread's rank in it).
template <class C, int C0, int NC>
__device__ __forceinline__ void transform_cols(unsigned char* s, int act, int t) {
  for (int i = t; i < C::ROWS * NC * 2; i += 128) {
    const int col = C0 + (i >> 1) % NC, r = (i >> 1) / NC;
    uint4* p = reinterpret_cast<uint4*>(s + r * C::PITCH + col * KROW + 16 * (i & 1));
    *p = transform8(*p, act);
  }
}

// Ready a stage that has arrived: spread a narrow stage's rows, or apply the
// transform on A in place to this thread's warpgroup's columns (0 .. 15 +
// 2 R, or the 16 after them), and fence it against the asynchronous proxy
// (the consumers meet on named barriers before any product reads it).
template <class C>
__device__ __forceinline__ void ready_stage(unsigned char* ring, int st, const Geometry& g,
                                            int x0, int tid) {
  unsigned char* s = ring + st * C::STAGE_BYTES;
  if constexpr (C::NARROW) {
    spread_stage<C>(s, g, x0, tid);
  } else {
    constexpr int W0 = 16 + 2 * C::R;             // warpgroup 0's columns
    if (tid < 128)
      transform_cols<C, 0, W0>(s, g.act, tid);
    else
      transform_cols<C, W0, 16>(s, g.act, tid - 128);
  }
  fence_proxy_async();
}

// After ready_stage of slot st (not a block's first stage) and the products
// of the stage before: the barrier on which each warpgroup waits until what
// its products read of slot st is ready (warpgroup 0 arrived on 3 + st
// right after its ready_stage).
template <class C>
__device__ __forceinline__ void meet_stage(int st, int wg) {
  if constexpr (C::NARROW)
    named_bar_sync(1, CONSUMERS);
  else
    named_bar_sync(wg == 0 ? 2 : 3 + st, wg == 0 ? 128 : CONSUMERS);
}

// The consumers' loop over stages k = (row tile, chunk). The products of
// stage k run while the next stage is waited for and readied; then they are
// waited for, the stage is released (one arrival per warp) and, at a row
// tile's last chunk, the epilogue runs.
template <class C, class Epi>
__device__ __forceinline__ void consume(const Epi& epi,
                                        typename Epi::template Shared<C::BN>& shared,
                                        const Geometry& g, unsigned char* ring, unsigned base,
                                        unsigned full, unsigned empty, int x0, int ntile,
                                        int i0, int nb, int b, int tid) {
  const int warp = tid >> 5, lane = tid & 31, wg = warp >> 2, w4 = warp & 3;
  if constexpr ((C::KNOCK & KNOCK_NO_DOTS) != 0) {
    // no main loop: each row tile's epilogue on zero accumulators
    const float zero[C::BN / 2] = {};
    epi.template prepare<C::BN>(shared, b, ntile, tid);
    named_bar_sync(1, CONSUMERS);
    for (int band = i0; band < i0 + nb; ++band) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int x = x0 + 8 * (2 * wg + mt);
        const auto pre = epi.template load<C::BN>(b, band * TH, x, ntile, lane, w4);
        epi.template apply<C::BN>(zero, pre, shared, b, band * TH, x, ntile, lane, w4);
      }
    }
    return;
  }
  const bool ready = C::NARROW || g.act;     // stages need a pass before the products
  float acc[2][C::BN / 2] = {};
  const int nk = nb * g.NCHUNKS;
  int st = 0;
  unsigned ph = 0;
  epi.template prepare<C::BN>(shared, b, ntile, tid);
  mbar_wait(full, 0);
  if (ready) ready_stage<C>(ring, 0, g, x0, tid);
  named_bar_sync(1, CONSUMERS);
  typename Epi::template Pre<C::BN> pre[2];
  for (int k = 0, q = 0, band = i0; k < nk; ++k) {
    const unsigned a = base + st * C::STAGE_BYTES, w = a + C::A_BYTES;
    wgmma_fence_acc(acc[0]);
    wgmma_fence_acc(acc[1]);
    wgmma_fence();
    // (the knock's copy of the tap loop apart, so that mask 0 compiles from
    // the same statements as before it existed: the same SASS)
    if constexpr ((C::KNOCK & KNOCK_NO_ROLLS) == 0) {
#pragma unroll
    for (int tap = 0; tap < C::TAPS; ++tap) {
      const unsigned win = (tap / C::KS) * C::PITCH + (tap % C::KS) * KROW;
      const uint64_t db = wgmma_desc(w + tap * C::TAP_BYTES, 8 * KROW, WGMMA_SWIZZLE_32B);
      const int scale_d = q != 0 || tap != 0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        Wgmma<C::BN>::mma(acc[mt],
                          wgmma_desc(a + win + (2 * wg + mt) * 8 * KROW, C::PITCH,
                                     WGMMA_SWIZZLE_32B),
                          db, scale_d);
    }
    } else {
#pragma unroll
      for (int tap = 0; tap < C::TAPS; ++tap) {   // every window at column R
        const unsigned win = (tap / C::KS) * C::PITCH + C::R * KROW;
        const uint64_t db = wgmma_desc(w + tap * C::TAP_BYTES, 8 * KROW, WGMMA_SWIZZLE_32B);
        const int scale_d = q != 0 || tap != 0;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          Wgmma<C::BN>::mma(acc[mt],
                            wgmma_desc(a + win + (2 * wg + mt) * 8 * KROW, C::PITCH,
                                       WGMMA_SWIZZLE_32B),
                            db, scale_d);
      }
    }
    wgmma_commit();
    if (q + 1 == g.NCHUNKS) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        pre[mt] = epi.template load<C::BN>(b, band * TH, x0 + 8 * (2 * wg + mt), ntile, lane,
                                           w4);
    }
    const int st1 = st + 1 == C::STAGES ? 0 : st + 1;
    const unsigned ph1 = st + 1 == C::STAGES ? ph ^ 1 : ph;
    if (k + 1 < nk) {
      mbar_wait(full + 8 * st1, ph1);
      if (ready) ready_stage<C>(ring, st1, g, x0, tid);
      // warpgroup 0's columns of the next stage are ready: warpgroup 1 need
      // not wait for warpgroup 0's products
      if (!C::NARROW && ready && wg == 0) named_bar_arrive(3 + st1, CONSUMERS);
    }
    wgmma_wait<0>();
    wgmma_fence_acc(acc[0]);
    wgmma_fence_acc(acc[1]);
    if (lane == 0) mbar_arrive(empty + 8 * st);
    if (k + 1 < nk && ready) meet_stage<C>(st1, wg);
    st = st1;
    ph = ph1;
    if (++q == g.NCHUNKS) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        epi.template apply<C::BN>(acc[mt], pre[mt], shared, b, band * TH,
                                  x0 + 8 * (2 * wg + mt), ntile, lane, w4);
      q = 0;
      ++band;
    }
  }
}

// The block: image blockIdx.z, row tiles [BANDS * blockIdx.y, ...), column
// strip and N tile from blockIdx.x (N tile fastest: the blocks that read one
// halo tile run side by side, so it comes from device memory once).
template <class C, class Epi>
__device__ __forceinline__ void run(const CUtensorMap* tmx, const unsigned char* wk,
                                    const Epi& epi, const Geometry& g) {
  extern __shared__ unsigned char engine_smem[];
  __shared__ __align__(8) unsigned long long bars[2 * C::STAGES];
  __shared__ __align__(16) typename Epi::template Shared<C::BN> shared;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // every box starts a swizzle pattern: the ring is 1024-byte aligned
  const unsigned raw = smem_u32(engine_smem);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* ring = engine_smem + (base - raw);
  const unsigned full = smem_u32(bars), empty = full + 8 * C::STAGES;
  const int ntile = blockIdx.x % g.NTILES, x0 = (blockIdx.x / g.NTILES) * OC;
  const int i0 = blockIdx.y * g.BANDS, b = blockIdx.z;
  const int nb = min(g.BANDS, g.NBANDS - i0);
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_fence_init();
    fence_proxy_async();
  }
  __syncthreads();
  // the two roles never meet again; each warpgroup changes its register
  // budget as a whole
  if (warp >= CONSUMER_WARPS) {
    if constexpr (C::MINB == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0)
      produce<C>(tmx, wk, g, base, full, empty, x0, ntile, i0, nb, b);
  } else {
    if constexpr (C::MINB == 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<C>(epi, shared, g, ring, base, full, empty, x0, ntile, i0, nb, b, tid);
  }
}

// ---- epilogue helpers ------------------------------------------------------

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Store one pixel's words: w[j] holds channels cb + 8 j + 2 t, + 1 (the
// accumulator layout) of the pixel at o (its channel 0), channels past cmax
// masked, nothing if !ok. Groups of four words go through a 4 x 4 transpose
// inside the quad (two exchanges), after which lane t holds the eight
// channels cb + 8 (4 i + t) .. + 7 and stores them as 16 bytes where the
// output's channel count is a multiple of 8; a tail of fewer than four words
// is stored as it is. Every lane of the warp takes part in the exchanges.
template <int G>
__device__ __forceinline__ void store_words(bf* o, unsigned (&w)[G], int cb, int cmax, bool ok,
                                            int t) {
  const bool odd = t & 1, hi = t & 2, wide = (cmax & 7) == 0;
#pragma unroll
  for (int i = 0; i < G / 4; ++i) {
    unsigned a[4] = {w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]};
    // with lane t ^ 1: rows s = t & 1 of (0, 1) and (2, 3), two words each
    const unsigned r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[1], 1);
    const unsigned r1 = __shfl_xor_sync(0xffffffffu, odd ? a[2] : a[3], 1);
    if (odd) { a[0] = r0; a[2] = r1; } else { a[1] = r0; a[3] = r1; }
    // with lane t ^ 2: row s = t, four words in channel order
    const unsigned q0 = __shfl_xor_sync(0xffffffffu, hi ? a[0] : a[2], 2);
    const unsigned q1 = __shfl_xor_sync(0xffffffffu, hi ? a[1] : a[3], 2);
    if (hi) { a[0] = q0; a[1] = q1; } else { a[2] = q0; a[3] = q1; }
    const int co = cb + 8 * (4 * i + t);
    if (!ok || co >= cmax) continue;
    if (wide) {                       // aligned, and co + 8 <= cmax
      *reinterpret_cast<uint4*>(o + co) = make_uint4(a[0], a[1], a[2], a[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (co + e < cmax)
          o[co + e] = __ushort_as_bfloat16((unsigned short)(a[e >> 1] >> (16 * (e & 1))));
    }
  }
#pragma unroll
  for (int j = G / 4 * 4; j < G; ++j) {
    const int co = cb + 8 * j + 2 * t;
    if (!ok || co >= cmax) continue;
    if ((cmax & 1) == 0) {            // aligned, and co + 2 <= cmax
      *reinterpret_cast<unsigned*>(o + co) = w[j];
    } else {
      o[co] = __ushort_as_bfloat16((unsigned short)w[j]);
      if (co + 1 < cmax) o[co + 1] = __ushort_as_bfloat16((unsigned short)(w[j] >> 16));
    }
  }
}

// read-only loads (ld.global.nc): free to move ahead of the epilogue's stores
__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// What an epilogue with no per-block constants and no read-ahead declares.
struct PlainEpilogue {
  template <int BN> struct Pre {};
  template <int BN> struct Shared {};
  template <int BN>
  __device__ __forceinline__ void prepare(Shared<BN>&, int, int, int) const {}
  template <int BN>
  __device__ __forceinline__ Pre<BN> load(int, int, int, int, int, int) const {
    return {};
  }
};

// Round the accumulator, add the bias in bf16, then the residual in bf16:
// the consumer conv of the fused unit (spade_block.cu) and the small-channel
// conv (conv3x3.cu).
struct BiasEpilogue : PlainEpilogue {
  bf* out;                     // (B, H, W, COUT)
  const float* bias;           // (NTILES * BN), rounded through bf16, zeros past COUT
  const bf* res;               // (B, H, W, COUT) with COUT % 8 == 0, or null
  int H, W, COUT;

  template <int BN>
  __device__ __forceinline__ void apply(const float (&d)[BN / 2], const Pre<BN>&,
                                        const Shared<BN>&, int b, int y, int x0, int ntile,
                                        int lane, int w4) const {
    const int g = lane >> 2, t = lane & 3, n0 = ntile * BN, px = x0 + g;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int py = y + 2 * w4 + half;
      const bool ok = py < H && px < W;
      const size_t pix = ok ? (size_t)(b * H + py) * W + px : 0;
      unsigned w[BN / 8];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = n0 + 8 * j + 2 * t;
        const float2 bc = ld2(bias + co);
        float v0 = rt<bf>(rt<bf>(d[4 * j + 2 * half]) + bc.x);
        float v1 = rt<bf>(rt<bf>(d[4 * j + 2 * half + 1]) + bc.y);
        if (res != nullptr && ok && co < COUT) {   // COUT % 8 == 0: co + 1 < COUT too
          const float2 r = ld2(res + pix * COUT + co);
          v0 = rt<bf>(v0 + r.x);
          v1 = rt<bf>(v1 + r.y);
        }
        w[j] = pack2(v0, v1);
      }
      store_words<BN / 8>(out + pix * COUT, w, n0, COUT, ok, t);
    }
  }
};

// ---- host ------------------------------------------------------------------

// Launch one engine kernel over the input `a` (B, H, W, CA) bf16, contiguous,
// 16-byte aligned, with the packed weights wk (NCHUNKS, NTILES, TAPS, BN, 16)
// bf16. CA % 8 == 0; or, for a narrow Cfg, CA < 15 with W * CA % 8 == 0 and
// `box` the elements of each of a row's two boxes (a multiple of 8, at most
// 256, 2 box >= (OC + 2) CA + 7: the boxes start on 16 bytes). A block walks as many row tiles as keeps about
// four blocks per SM in the grid, at most MAX_BANDS. Returns a cudaError_t,
// or 1000 + the CUresult if the tensor map cannot be encoded.
template <class C, class Epi, typename Kernel>
int launch(Kernel kernel, const void* a, const void* wk, int B, int H, int W, int CA,
           int NTILES, int act, const Epi& epi, cudaStream_t stream, int box = 0) {
  if (B <= 0 || H <= 0 || W <= 0 || CA <= 0 || NTILES <= 0 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  if (C::NARROW ? CA > 14 || (long long)W * CA % 8 || box % 8 || box <= 0 || box > 256 ||
                      2 * box < C::COLS * CA + 7
                : CA % 8 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmx;
  const CUresult res = C::NARROW ? encode_rows(&tmx, a, B, H, W, CA, box, C::ROWS)
                                 : encode_x(&tmx, a, B, H, W, CA, C::SC, C::ROWS);
  if (res != CUDA_SUCCESS) return 1000 + (int)res;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err == cudaSuccess && C::MINB > 1)   // the SM's whole carve-out to shared memory
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  Geometry g;
  g.H = H;
  g.W = W;
  g.NCHUNKS = (CA + KC - 1) / KC;
  g.NTILES = NTILES;
  g.NBANDS = (H + TH - 1) / TH;
  g.act = act;
  g.cin = CA;
  g.box = box;
  const long long strips = (W + OC - 1) / OC;
  const long long tiles = strips * NTILES * g.NBANDS * B;
  const long long bands = tiles / (4ll * sm_count());
  g.BANDS = bands < 1 ? 1 : bands > MAX_BANDS ? MAX_BANDS : (int)bands;
  const dim3 grid((unsigned)(strips * NTILES), (g.NBANDS + g.BANDS - 1) / g.BANDS, B);
  kernel<<<grid, NT, C::SMEM, stream>>>(tmx, static_cast<const unsigned char*>(wk), epi, g);
  return (int)cudaGetLastError();
}

}  // namespace engine
}  // namespace hv
