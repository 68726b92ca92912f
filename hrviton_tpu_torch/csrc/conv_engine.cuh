// One TMA / wgmma convolution engine for the model's kernels on Hopper
// (sm_90a): a KS x KS stride-1 convolution (KS = 1 or 3, zero padding KS / 2)
// of an NHWC bf16 input with any channel count that is a multiple of 8, f32
// accumulation, a transform on the input and an epilogue that each kernel
// chooses. It generalises the design of csrc/conv_tma.cu's conv_halo_tma_kernel
// and keeps its structure:
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
// to whole tiles, a transform on A and an epilogue policy.
//
// The transform on A (0 none, 1 relu, 2 leaky 0.2 with the slope and the
// product rounded to bf16, as a bf16 tensor multiplied by 0.2 gives them) is
// applied to the halo tile in shared memory, in place, once per stage, after
// the full barrier and while the previous stage's products run; then each
// thread fences its generic writes against the asynchronous proxy and the
// 256 consumer threads meet on a named barrier before the products read the
// tile. act(0) = 0, so the zero border stays zero. In shared memory and not
// on register-A fragments because the tile is read by both warpgroups (their
// windows overlap by two columns) and by nine taps: one pass over its 12.8 KB
// a stage costs less than transforming every window's fragments nine times,
// and keeps one descriptor path for all operands. Elementwise, so the swizzle
// does not matter.
//
// The epilogue policy is a struct with a type and two device members
//   template <int BN> struct Pre;      // what it reads ahead (may be empty)
//   template <int BN> Pre<BN> load(int b, int y, int x, int ntile, int lane,
//                                  int w4) const;
//   template <int BN> void apply(const float (&d)[BN / 2], const Pre<BN>& pre,
//                                int b, int y, int x, int ntile, int lane,
//                                int w4) const;
// per M tile (8 x 8 pixels from row y, column x of image b): load() runs while
// the row tile's last products are in flight, so that the epilogue's reads
// from device memory overlap them; apply() then gets this thread's
// accumulators, keeps the rounding chain of its plain version and masks what
// lies past H, W and the output channels. store_words() below is the common
// store.

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

// What every launch of the engine is told.
struct Geometry {
  int H, W;       // the image (B is gridDim.z)
  int NCHUNKS;    // K chunks: the input's channels / 16, rounded up
  int NTILES;     // N tiles of BN columns
  int NBANDS;     // row tiles: H / TH rounded up
  int BANDS;      // row tiles a block walks
  int act;        // the transform on A
};

template <int KS_, int BN_>
struct Cfg {
  static constexpr int KS = KS_, BN = BN_;
  static constexpr int R = KS / 2, TAPS = KS * KS;
  // staged columns: OC + 2 for a 3 x 3 halo, rounded up so that a tile row's
  // pitch stays a multiple of the 256-byte swizzle pattern (one descriptor
  // spans an 8 x 8 tile: the next eight M rows are the next tile row)
  static constexpr int SC = KS == 3 ? OC + 8 : OC;
  static constexpr int ROWS = TH + 2 * R;
  static constexpr int PITCH = SC * KROW;
  static constexpr int A_TX = ROWS * PITCH;               // bytes of a stage's box
  static constexpr int A_BYTES = align_up(A_TX, 1024);
  static constexpr int TAP_BYTES = BN * KROW;
  static constexpr int W_BYTES = TAPS * TAP_BYTES;        // a stage's weights
  static constexpr int STAGE_BYTES = align_up(A_BYTES + W_BYTES, 1024);
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 256) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 1024;
  static_assert(BN % 8 == 0 && BN <= 256, "a wgmma N");
  static_assert(STAGES >= 2, "a ring needs two stages");
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
  int st = 0;
  unsigned ph = 0;
  for (int band = i0; band < i0 + nb; ++band) {
    const int y = band * TH - C::R;
    for (int q = 0; q < g.NCHUNKS; ++q) {
      mbar_wait(empty + 8 * st, ph ^ 1);
      const unsigned bar = full + 8 * st, a = base + st * C::STAGE_BYTES;
      mbar_expect_tx(bar, C::A_TX + C::W_BYTES);
      tma_load_4d(a, tmx, bar, q * KC, x0 - C::R, y, b);
      bulk_load(a + C::A_BYTES, wk + ((size_t)q * g.NTILES + ntile) * C::W_BYTES, C::W_BYTES,
                bar);
      if (++st == C::STAGES) { st = 0; ph ^= 1; }
    }
  }
}

// Ready a stage that has arrived: apply the transform on A in place and fence
// it against the asynchronous proxy (the consumers meet on the named barrier
// before any product reads it).
template <class C>
__device__ __forceinline__ void ready_stage(unsigned char* ring, int st, int act, int tid) {
  uint4* t = reinterpret_cast<uint4*>(ring + st * C::STAGE_BYTES);
  for (int i = tid; i < C::A_TX / 16; i += CONSUMERS) t[i] = transform8(t[i], act);
  fence_proxy_async();
}

// The consumers' loop over stages k = (row tile, chunk). The products of
// stage k run while the next stage is waited for and transformed; then they
// are waited for, the stage is released (one arrival per warp) and, at a row
// tile's last chunk, the epilogue runs.
template <class C, class Epi>
__device__ __forceinline__ void consume(const Epi& epi, const Geometry& g, unsigned char* ring,
                                        unsigned base, unsigned full, unsigned empty, int x0,
                                        int ntile, int i0, int nb, int b, int tid) {
  const int warp = tid >> 5, lane = tid & 31, wg = warp >> 2, w4 = warp & 3;
  float acc[2][C::BN / 2] = {};
  const int nk = nb * g.NCHUNKS;
  int st = 0;
  unsigned ph = 0;
  mbar_wait(full, 0);
  if (g.act) {
    ready_stage<C>(ring, 0, g.act, tid);
    named_bar_sync(1, CONSUMERS);
  }
  typename Epi::template Pre<C::BN> pre[2];
  for (int k = 0, q = 0, band = i0; k < nk; ++k) {
    const unsigned a = base + st * C::STAGE_BYTES, w = a + C::A_BYTES;
    wgmma_fence_acc(acc[0]);
    wgmma_fence_acc(acc[1]);
    wgmma_fence();
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
      if (g.act) ready_stage<C>(ring, st1, g.act, tid);
    }
    wgmma_wait<0>();
    wgmma_fence_acc(acc[0]);
    wgmma_fence_acc(acc[1]);
    if (lane == 0) mbar_arrive(empty + 8 * st);
    if (k + 1 < nk && g.act) named_bar_sync(1, CONSUMERS);
    st = st1;
    ph = ph1;
    if (++q == g.NCHUNKS) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        epi.template apply<C::BN>(acc[mt], pre[mt], b, band * TH, x0 + 8 * (2 * wg + mt), ntile,
                                  lane, w4);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0)
      produce<C>(tmx, wk, g, base, full, empty, x0, ntile, i0, nb, b);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<C>(epi, g, ring, base, full, empty, x0, ntile, i0, nb, b, tid);
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

// ---- host ------------------------------------------------------------------

inline int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      v = 132;
    return v;
  }();
  return n;
}

// Launch one engine kernel over the input `a` (B, H, W, CA) bf16, contiguous,
// 16-byte aligned, CA % 8 == 0, with the packed weights wk (NCHUNKS, NTILES,
// TAPS, BN, 16) bf16. A block walks as many row tiles as keeps about four
// blocks per SM in the grid, at most MAX_BANDS. Returns a cudaError_t, or 1000
// + the CUresult if the tensor map cannot be encoded.
template <class C, class Epi, typename Kernel>
int launch(Kernel kernel, const void* a, const void* wk, int B, int H, int W, int CA,
           int NTILES, int act, const Epi& epi, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || CA <= 0 || CA % 8 || NTILES <= 0 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmx;
  const CUresult res = encode_x(&tmx, a, B, H, W, CA, C::SC, C::ROWS);
  if (res != CUDA_SUCCESS) return 1000 + (int)res;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  Geometry g;
  g.H = H;
  g.W = W;
  g.NCHUNKS = (CA + KC - 1) / KC;
  g.NTILES = NTILES;
  g.NBANDS = (H + TH - 1) / TH;
  g.act = act;
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
