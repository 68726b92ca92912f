// The weight gradient of a 3x3 stride-1 pad-1 convolution on Hopper (sm_90a):
//
//   dW[co, ci, ky, kx] = sum over n, h, w of act(x)[n, h + ky - 1, w + kx - 1, ci]
//                                           * g[n, h, w, co],
//
// x (N, H, W, Cin) and g (N, H, W, Cout) bf16 (x NHWC, g NHWC or NCHW),
// zero outside the image,
// act none, relu or leaky 0.2 (in bf16, as ops/conv3x3.py:activation rounds
// it), products in bf16 on wgmma, sums in f32, dW written once as (Cout, Cin,
// 3, 3) in bf16 or f32. The kernel of ops/conv3x3.py:wgrad3x3, which
// wgrad_taps takes for bf16 on the card (the training step's weight gradient
// of every library 3x3 conv under taps_wgrad).
//
// It replaces no TPU kernel: the JAX package's weight gradient,
// hrviton_tpu/ops/conv3x3.py:_wgrad_taps (:280), is XLA's contraction of bf16
// operands into f32. What it replaces in the port is the f32 path
// (ops/conv3x3.py:_wgrad_rows): a padded copy of x, each row chunk of x and g
// cast to f32, nine shifted tap slices copied, 9 * H / R small f32 SIMT
// matmuls with TF32 off and an f32 accumulator (267.7 ms of the stage-2 step's
// 705 ms at batch 2, 1024x768; PERF.md §5). Its bound on an H100: the step's
// 94 calls are 3.233 TFLOP, 3.27 ms at 989 TFLOP/s, and read x and g once,
// 8.44 GB, 2.52 ms at 3.35 TB/s: operations bound it, just.
//
// Design, against that bound:
//   * the reduction runs over pixels (K = N H W); an NHWC operand, pixel-
//     major with its channels contiguous, arrives by TMA as boxes of 16
//     channels x 8 columns x rows, laid out by the 32-byte swizzle as
//     wgmma's MN-major layout (the descriptors' transpose bits), so no
//     operand is transposed or copied on the way;
//   * g comes as the backward of the conv's consumer wrote it: NHWC, a box
//     of 16 channels like x's, or (80 of the cell's 94 calls) NCHW, read as
//     it is through a 5-D map, one box a stage, as wgmma's K-major operand
//     with no swizzle (no permuting copy, which took 12 ms a step);
//   * the zero padding is TMA's out-of-bounds fill: x is loaded as three
//     boxes a channel group, at columns w0 - 1, w0, w0 + 1 (kx) and rows h0 -
//     1 .. h0 + 16 of the unpadded tensor; tap (ky, kx) is box kx from row ky
//     on, a whole-row offset of 8 pixels, one swizzle group (no F.pad, no
//     shifted copy);
//   * a block owns 64 channels of one operand (the wgmma M side) and BN of
//     the other for all nine taps: three consumer warpgroups, one per ky,
//     each holding kx = 0, 1, 2 in registers for the whole K loop, share the
//     three x boxes and the g box of a stage; one producer thread keeps a ring
//     of stages in flight on full / empty mbarriers;
//   * the pre-activation is applied to each arrived x stage in shared memory
//     (bf16 rounding as activation()) by the producer warpgroup's three
//     other warps, which then arrive on the stage's ready barrier, while the
//     consumers' products run on earlier stages: no register of a consumer
//     and none of its time go to it; act(0) = 0 keeps the padding zero;
//   * which operand takes the M side, and BN, follow the shape
//     (ops/conv3x3.py:wgrad3x3_tiles): x for 128 -> 80, g for 7 -> 128, BN
//     at most 64 (three taps of BN / 2 accumulators within 128 registers);
//     boxes that start past a tensor's channels are neither loaded nor
//     transformed (zeroed once), channels past them inside a box are TMA's
//     zero fill, and past Cin / Cout the epilogue writes nothing; an NHWC
//     operand whose pixel is no multiple of 16 bytes (7, 9 or 3 channels)
//     is read from a zero-padded copy the wrapper makes;
//   * where the output tiles alone cannot fill the card, the pixels are
//     split across blocks (grid y); each block writes its f32 partial sums
//     through shared memory, coalesced in dW's layout, and a second kernel
//     adds the partials in a fixed order and rounds once, so two launches give
//     the same bits. One split: the block rounds and writes dW itself.

#include "mma_utils.cuh"
#include "tma_wgmma.cuh"

namespace {

using namespace hv;

constexpr int TW = 8;                        // columns of a pixel tile: one 8-row swizzle group a row
constexpr int TH = 16;                       // rows of a pixel tile
constexpr int KSTEPS = TH * TW / 16;         // wgmma K steps (16 pixels) of a tile
constexpr int ROW = 32;                      // bytes of a pixel's 16 channels: the swizzle width
constexpr int XBOX = (TH + 2) * TW * ROW;    // a 16-channel box of x with its two halo rows
constexpr int GBOX = TH * TW * ROW;          // a 16-channel box of g
constexpr int BM = 64;                       // channels of the M side a block
constexpr int CONSUMERS = 384;               // three warpgroups, one per ky
constexpr int NT = CONSUMERS + 128;          // and the producer's warpgroup:
constexpr int TRANSFORMERS = 96;             // its warps but the TMA issuer's
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;           // bytes of shared memory a block may use

template <int BN_, bool XM_, bool GK_>
struct Cfg {
  static constexpr int BN = BN_;
  static constexpr bool XM = XM_;            // x's channels on the M side (D's rows)
  static constexpr bool GK = GK_;            // g read as NCHW: K-major
  static constexpr int CX = XM ? BM : BN, CG = XM ? BN : BM;
  static constexpr int XG = CX / 16, GG = CG / 16;         // 16-channel boxes a stage
  static constexpr int X_BYTES = 3 * XG * XBOX;            // [kx][group] boxes of x
  static constexpr int G_BYTES = GG * GBOX;   // NCHW: [k step][row of 2][channel][8 pixels]
  static constexpr int STAGE = X_BYTES + G_BYTES;          // a multiple of 256
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 128) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  // the epilogue's staging of the block's nine taps, [co][ci][tap] f32, in
  // the ring: a pitch of CI_T * 9 + 4 floats an output channel keeps the
  // fragments' stores off each other's banks
  static constexpr int CO_T = XM ? BN : BM, CI_T = XM ? BM : BN;
  static constexpr int PITCH = CI_T * 9 + 4;
  static constexpr int EPI = CO_T * PITCH * 4;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = (RING > EPI ? RING : EPI) + 1024;
  // three taps of BN / 2 accumulators a consumer thread within the 128
  // registers 512 threads have: BN = 80 spills, and ptxas serialises its wgmma
  static_assert(BN % 16 == 0 && BN <= 64, "a 16-channel box a group, three taps a warpgroup");
  static_assert(STAGE % 256 == 0, "every box starts a swizzle pattern");
  static_assert(STAGES >= 2, "a ring needs two stages");
  static_assert(SMEM + 128 <= SMEM_LIMIT, "shared memory");
};

struct Params {
  void* dst;         // dW (COUT, CIN, 3, 3), bf16 (out_bf16) or f32; with
                     // splits > 1 the f32 partials (splits, COUT, CIN, 9)
  int H, W, CIN, COUT;
  int RT, CT, NTK;   // row tiles, column tiles of an image; pixel tiles in all
  int splits, mtiles;
  int act, out_bf16;
  int CXT, CGT;      // the channels of the x and g tensors as they are read
};

// One box of a 5-D tensor map into shared memory (as tma_load_4d).
__device__ __forceinline__ void tma_load_5d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3), "r"(c4)
      : "memory");
}

// The descriptor of a K-major operand with no swizzle: core matrices of 8
// rows x 16 bytes (8 values of K) contiguous, the next 8 rows 128 bytes on
// (the stride byte offset), the next 8 values of K `lbo` bytes on.
__device__ __forceinline__ uint64_t desc_k(unsigned addr, unsigned lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// The boxes of x and of g a block's stage loads, of its XG and GG: those that
// start inside the tensor's channels; the others stay zero.
struct Groups {
  int nxg, ngg;
};

// The shared-memory descriptor of an MN-major operand in the 32-byte swizzle:
// 16 channels (32 bytes) of a pixel contiguous, 8 pixels (K) a 256-byte
// pattern, the next 8 pixels 256 bytes on (the stride byte offset), the next
// 16 channels `lbo` bytes on (the leading byte offset: one box further).
__device__ __forceinline__ uint64_t desc_mn(unsigned addr, unsigned lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)WGMMA_SWIZZLE_32B << 62);
}

// wgmma.mma_async m64nNk16, bf16 in, f32 accumulator, both operands in
// shared memory, d += a b; TA, TB: the transpose bits, 1 for an MN-major
// operand, 0 for a K-major one. Thread 32 w + 4 g + t of the warpgroup holds
// rows 16 w + g (d[4 j], d[4 j + 1]) and 16 w + g + 8 (d[4 j + 2], d[4 j +
// 3]) at columns 8 j + 2 t, + 1.
template <int N, int TA, int TB> struct WgmmaT;

template <int TA, int TB> struct WgmmaT<16, TA, TB> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, "
        "%8, %9, p, 1, 1, %11, %12;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB> struct WgmmaT<32, TA, TB> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, "
        "%16, %17, p, 1, 1, %19, %20;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB> struct WgmmaT<48, TA, TB> {
  __device__ __forceinline__ static void mma(float (&d)[24], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, "
        "%24, %25, p, 1, 1, %27, %28;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB> struct WgmmaT<64, TA, TB> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, "
        "%32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

// The producer's lane: pixel tiles t0 .. t0 + nt - 1, one stage each.
template <class C>
__device__ __forceinline__ void produce(const CUtensorMap* tmx, const CUtensorMap* tmg,
                                        const Params& p, const Groups& q, unsigned base,
                                        unsigned full, unsigned empty, int cx0, int cg0, int t0,
                                        int nt) {
  for (int i = 0; i < nt; ++i) {
    const int st = i % C::STAGES;
    mbar_wait(empty + 8 * st, ((i / C::STAGES) & 1) ^ 1);
    const int t = t0 + i, c = t % p.CT, r = (t / p.CT) % p.RT, n = t / (p.CT * p.RT);
    const int y = r * TH, x = c * TW;
    const unsigned s = base + st * C::STAGE, bar = full + 8 * st;
    mbar_expect_tx(bar, 3 * q.nxg * XBOX + (C::GK ? C::G_BYTES : q.ngg * GBOX));
    for (int kx = 0; kx < 3; ++kx)
      for (int j = 0; j < q.nxg; ++j)
        tma_load_4d(s + (kx * C::XG + j) * XBOX, tmx, bar, cx0 + 16 * j, x + kx - 1, y - 1, n);
    if constexpr (C::GK)      // (w, channel, row in the pair, pair of rows, image)
      tma_load_5d(s + C::X_BYTES, tmg, bar, x, cg0, 0, y / 2, n);
    else
      for (int j = 0; j < q.ngg; ++j)
        tma_load_4d(s + C::X_BYTES + j * GBOX, tmg, bar, cg0 + 16 * j, x, y, n);
  }
}

template <class C>
__device__ __forceinline__ void fence_all(float (&acc)[3][C::BN / 2]) {
  wgmma_fence_acc(acc[0]);
  wgmma_fence_acc(acc[1]);
  wgmma_fence_acc(acc[2]);
}

// act(v) on 8 bf16 values: relu, or leaky 0.2 as max(v, v * bf16(0.2)) with
// the product rounded once to bf16 (mul.bf16x2: the product of two bf16 is
// exact before the rounding), as a bf16 tensor times 0.2 gives it.
template <int ACT>
__device__ __forceinline__ uint4 act8(uint4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f), slope = __float2bfloat162_rn(0.2f);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __hmax2(h[e], ACT == 1 ? zero : __hmul2(h[e], slope));
  return v;
}

// The transformers' loop (with a pre-activation): each arrived stage's
// loaded x boxes, in place, four 16-byte words at a time, fenced against the
// asynchronous proxy before the arrival on the stage's ready barrier that
// the consumers wait on. t: the thread's rank among the transformers.
template <class C, int ACT>
__device__ __forceinline__ void transform(const Groups& g, unsigned char* ring, unsigned full,
                                          unsigned ready, int nt, int t) {
  constexpr int T = TRANSFORMERS;
  const int words = g.nxg * XBOX / 16;         // of one kx's loaded boxes
  for (int i = 0; i < nt; ++i) {
    const int st = i % C::STAGES;
    mbar_wait(full + 8 * st, (i / C::STAGES) & 1);
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      uint4* w = reinterpret_cast<uint4*>(ring + st * C::STAGE + kx * C::XG * XBOX);
      int q = t;
      for (; q + 3 * T < words; q += 4 * T) {
        const uint4 a0 = w[q], a1 = w[q + T], a2 = w[q + 2 * T], a3 = w[q + 3 * T];
        w[q] = act8<ACT>(a0);
        w[q + T] = act8<ACT>(a1);
        w[q + 2 * T] = act8<ACT>(a2);
        w[q + 3 * T] = act8<ACT>(a3);
      }
      for (; q < words; q += T) w[q] = act8<ACT>(w[q]);
    }
    fence_proxy_async();
    mbar_arrive(ready + 8 * st);
  }
}

// The consumers' loop: stage i's 3 x KSTEPS products on this warpgroup's row
// ky once it has arrived (and been transformed), then stage i - 1 released
// once its products are done.
template <class C>
__device__ __forceinline__ void consume(unsigned base, unsigned arrived, unsigned empty, int nt,
                                        int tid, int ky, float (&acc)[3][C::BN / 2]) {
  for (int i = 0; i < nt; ++i) {
    const int st = i % C::STAGES;
    mbar_wait(arrived + 8 * st, (i / C::STAGES) & 1);
    const unsigned s = base + st * C::STAGE;
    fence_all<C>(acc);
    wgmma_fence();
    constexpr int TG = C::GK ? 0 : 1;            // g's transpose bit
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k) {
      // NCHW g: K step k (a pair of rows) as two halves of 8 pixels, each
      // CG channels of 16 bytes
      const uint64_t dg = C::GK ? desc_k(s + C::X_BYTES + k * C::CG * ROW, C::CG * 16)
                                : desc_mn(s + C::X_BYTES + k * 16 * ROW, GBOX);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const uint64_t dx = desc_mn(s + kx * C::XG * XBOX + (ky * TW + 16 * k) * ROW, XBOX);
        if constexpr (C::XM)
          WgmmaT<C::BN, 1, TG>::mma(acc[kx], dx, dg);
        else
          WgmmaT<C::BN, TG, 1>::mma(acc[kx], dg, dx);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_all<C>(acc);
    if (i > 0 && (tid & 127) == 0) mbar_arrive(empty + 8 * ((i - 1) % C::STAGES));
  }
  wgmma_wait<0>();
  fence_all<C>(acc);
}

template <int BN, bool XM, bool GK>
__global__ void __launch_bounds__(NT, 1)
    wgrad3x3_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmg, const Params p) {
  using C = Cfg<BN, XM, GK>;
  extern __shared__ unsigned char wgrad_smem[];
  __shared__ __align__(8) unsigned long long bars[3 * MAX_STAGES];
  // the warp index broadcast from lane 0: the roles' branch warp-uniform to
  // ptxas (PERF.md §6: a branch it must treat as divergent serialises wgmma)
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  // every box starts a swizzle pattern: the ring is 1024-byte aligned
  const unsigned raw = smem_u32(wgrad_smem), base = (raw + 1023u) & ~1023u;
  unsigned char* ring = wgrad_smem + (base - raw);
  const unsigned full = smem_u32(bars), empty = full + 8 * C::STAGES;
  const unsigned ready = empty + 8 * C::STAGES;
  const int m0 = (int)(blockIdx.x % p.mtiles) * BM, n0 = (int)(blockIdx.x / p.mtiles) * BN;
  const int split = blockIdx.y;
  const int cx0 = XM ? m0 : n0, cg0 = XM ? n0 : m0;
  const Groups q{min(C::XG, (p.CXT - cx0 + 15) / 16),
                 GK ? C::GG : min(C::GG, (p.CGT - cg0 + 15) / 16)};
  const int t0 = (int)((long long)split * p.NTK / p.splits);
  const int nt = (int)((long long)(split + 1) * p.NTK / p.splits) - t0;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 3);
      mbar_init(ready + 8 * s, TRANSFORMERS);
    }
    mbar_fence_init();
  }
  // the boxes no stage loads (past the tensors' channels) are zero for the
  // products, once
  {
    const int xz = (C::XG - q.nxg) * XBOX / 16, gz = (C::GG - q.ngg) * GBOX / 16;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int k = tid; k < C::STAGES * (3 * xz + gz); k += NT) {
      const int st = k / (3 * xz + gz), r = k - st * (3 * xz + gz);
      uint4* v = reinterpret_cast<uint4*>(ring + st * C::STAGE);
      if (r < 3 * xz)
        v[(r / xz) * (C::XG * XBOX / 16) + q.nxg * XBOX / 16 + r % xz] = zero;
      else
        v[(C::X_BYTES + q.ngg * GBOX) / 16 + r - 3 * xz] = zero;
    }
    fence_proxy_async();
  }
  __syncthreads();
  // the two roles never meet again
  if (warp >= CONSUMERS / 32) {
    if (tid == CONSUMERS)
      produce<C>(&tmx, &tmg, p, q, base, full, empty, cx0, cg0, t0, nt);
    else if (p.act == 1 && warp > CONSUMERS / 32)
      transform<C, 1>(q, ring, full, ready, nt, tid - CONSUMERS - 32);
    else if (p.act == 2 && warp > CONSUMERS / 32)
      transform<C, 2>(q, ring, full, ready, nt, tid - CONSUMERS - 32);
    return;
  }
  const int ky = warp >> 2;
  float acc[3][BN / 2];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[kx][e] = 0.f;
  consume<C>(base, p.act ? ready : full, empty, nt, tid, ky, acc);

  // epilogue: every warpgroup's products have read the ring; stage the nine
  // taps as [co][ci][tap], then write the block's (co, ci) rectangle of dW
  // (or of its partial) as runs of CI_T * 9 contiguous elements
  named_bar_sync(2, CONSUMERS);
  float* stg = reinterpret_cast<float*>(ring);
  const int lane = tid & 31, w4 = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * w4 + g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
        const int co = XM ? n : m, ci = XM ? m : n;
        stg[co * C::PITCH + ci * 9 + 3 * ky + kx] = acc[kx][4 * j + e];
      }
  named_bar_sync(2, CONSUMERS);
  const int co0 = XM ? n0 : m0, ci0 = XM ? m0 : n0;
  const int nco = min(C::CO_T, p.COUT - co0), len = min(C::CI_T, p.CIN - ci0) * 9;
  const size_t row = (size_t)p.CIN * 9;
  const size_t at = (size_t)co0 * row + (size_t)ci0 * 9;
  if (p.out_bf16) {
    bf* o = static_cast<bf*>(p.dst) + at;
    for (int idx = tid; idx < nco * len; idx += CONSUMERS) {
      const int co = idx / len, rem = idx - co * len;
      o[co * row + rem] = __float2bfloat16_rn(stg[co * C::PITCH + rem]);
    }
  } else {
    float* o = static_cast<float*>(p.dst) + (size_t)split * p.COUT * row + at;
    for (int idx = tid; idx < nco * len; idx += CONSUMERS) {
      const int co = idx / len, rem = idx - co * len;
      o[co * row + rem] = stg[co * C::PITCH + rem];
    }
  }
}

// dW = the sum of the splits' f32 partials, in split order, rounded once.
__global__ void __launch_bounds__(256)
    wgrad3x3_sum_kernel(const float* __restrict__ part, void* out, long long E, int splits,
                        int out_bf16) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += (long long)gridDim.x * blockDim.x) {
    float s = part[e];
    for (int k = 1; k < splits; ++k) s += part[k * E + e];
    if (out_bf16)
      static_cast<bf*>(out)[e] = __float2bfloat16_rn(s);
    else
      static_cast<float*>(out)[e] = s;
  }
}

// g (N, C, H, W) bf16, its images `sn` elements apart, as a 5-D map over
// (w, channel, row in a pair of rows, pair of rows, image): a box {8, cg, 2,
// TH / 2, 1} is, per pair of rows (a K step of 16 pixels, in x's order), two
// halves of 8 pixels, each cg channels of 16 bytes: wgmma's K-major operand
// with no swizzle (core matrices of 8 channels x 8 pixels). Needs W % 8 == 0
// (the rows' strides multiples of 16 bytes), H % 2 == 0 and sn % 8 == 0.
inline CUresult encode_nchw(CUtensorMap* map, const void* g, int N, int C, int H, int W,
                            long long sn, int cg) {
  EncodeFn fn = encode_fn();
  if (!fn) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[5] = {(cuuint64_t)W, (cuuint64_t)C, 2, (cuuint64_t)H / 2, (cuuint64_t)N};
  const cuuint64_t strides[4] = {(cuuint64_t)H * W * 2, (cuuint64_t)W * 2, (cuuint64_t)W * 4,
                                 (cuuint64_t)sn * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)cg, 2, TH / 2, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(g), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN, bool XM, bool GK>
int launch(const void* x, const void* g, void* part, void* out, int N, int H, int W, int CX,
           int CG, long long gsn, int CIN, int COUT, int splits, int act, int out_bf16,
           cudaStream_t stream) {
  using C = Cfg<BN, XM, GK>;
  CUtensorMap tmx, tmg;
  CUresult res = encode_x(&tmx, x, N, H, W, CX, TW, TH + 2);
  if (res == CUDA_SUCCESS)
    res = GK ? encode_nchw(&tmg, g, N, CG, H, W, gsn, C::CG)
             : encode_x(&tmg, g, N, H, W, CG, TW, TH);
  if (res != CUDA_SUCCESS) return 1000 + (int)res;
  auto kernel = wgrad3x3_kernel<BN, XM, GK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.H = H;
  p.W = W;
  p.CIN = CIN;
  p.COUT = COUT;
  p.RT = (H + TH - 1) / TH;
  p.CT = (W + TW - 1) / TW;
  p.NTK = N * p.RT * p.CT;
  p.splits = splits;
  p.mtiles = ((XM ? CIN : COUT) + BM - 1) / BM;
  p.act = act;
  p.out_bf16 = splits == 1 && out_bf16;
  p.dst = splits == 1 ? out : part;
  p.CXT = CX;
  p.CGT = CG;
  const int ntiles = ((XM ? COUT : CIN) + BN - 1) / BN;
  kernel<<<dim3(p.mtiles * ntiles, splits), NT, C::SMEM, stream>>>(tmx, tmg, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long E = (long long)COUT * CIN * 9;
  const long long blocks = (E + 255) / 256;
  const int grid = (int)(blocks < 8ll * sm_count() ? blocks : 8ll * sm_count());
  wgrad3x3_sum_kernel<<<grid, 256, 0, stream>>>(static_cast<const float*>(part), out, E, splits,
                                                out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (N, H, W, CX) bf16, contiguous; g: (N, H, W, CG) bf16, contiguous
// (g_nchw 0), or (N, CG, H, W) bf16 with its channel planes contiguous and
// its images g_sn elements apart (g_nchw 1: W % 8 == 0, H % 2 == 0, g_sn %
// 8 == 0); both 16-byte aligned; CX and an NHWC g's CG multiples of 8 (a
// copy with zero channels where the tensor's are not); CIN <= CX and COUT <=
// CG the channels of dW. out: (COUT,
// CIN, 3, 3), bf16 (out_bf16) or f32. BN: 16, 32, 48 or 64; xm: x on the M
// side. splits: blocks over the pixels of each output tile; with more than
// one, part is (splits, COUT, CIN, 9) f32 scratch. act: 0 none, 1 relu, 2
// leaky 0.2. Returns a cudaError_t, or 1000 + the CUresult of a tensor map
// that cannot be encoded.
#define HV_WGRAD_CASE(BN_, XM_, GK_)                                                        \
  case BN_ * 4 + XM_ * 2 + GK_:                                                            \
    return launch<BN_, XM_, GK_>(x, g, part, out, N, H, W, CX, CG, g_sn, CIN, COUT, splits, \
                                 act, out_bf16, s)
#define HV_WGRAD(BN_)               \
  HV_WGRAD_CASE(BN_, false, false); \
  HV_WGRAD_CASE(BN_, false, true);  \
  HV_WGRAD_CASE(BN_, true, false);  \
  HV_WGRAD_CASE(BN_, true, true)
int wgrad3x3_bf16(const void* x, const void* g, void* part, void* out, int N, int H, int W,
                  int CX, int CG, int CIN, int COUT, int BN, int xm, int g_nchw,
                  long long g_sn, int splits, int act, int out_bf16, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || CX % 8 ||
      (g_nchw ? W % 8 || H % 2 || g_sn % 8 || g_sn < (long long)CG * H * W : CG % 8) ||
      CIN <= 0 || COUT <= 0 || CIN > CX || COUT > CG || splits <= 0 || splits > 65535 ||
      (splits > 1 && part == nullptr) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (BN * 4 + (xm != 0) * 2 + (g_nchw != 0)) {
    HV_WGRAD(16);
    HV_WGRAD(32);
    HV_WGRAD(48);
    HV_WGRAD(64);
  }
  return (int)cudaErrorInvalidValue;
}
#undef HV_WGRAD
#undef HV_WGRAD_CASE

}  // extern "C"
