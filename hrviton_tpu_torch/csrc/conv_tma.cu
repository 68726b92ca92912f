// Seven formulations of the 3x3 stride-1 pad-1 convolution experiment designed
// for Hopper's asynchronous units (sm_90a): the input tile with its halo and
// its zero border arrives by TMA straight from the unpadded x, and the
// products run on wgmma. All compute the same conv (bf16 in, f32 accumulation
// over all nine taps and all of Cin, one rounding to bf16, no bias, no
// activation).
//
//   conv_halo_tma_kernel replaces the TPU kernel
//     tools/exp_pallas_conv2.py:_kernel_halo (through conv_halo, pl.pallas_call
//     at exp_pallas_conv2.py:98): a standard blocked kernel, one halo tile per
//     step, the nine taps nine windows of that one tile, nine products. The
//     TPU tool gathers overlapping row tiles in device memory first, because a
//     BlockSpec cannot cut overlapping blocks. A TMA tensor map over x can: a
//     box at the signed coordinate (x0 - 1, y0 - 1) is the halo tile, and what
//     lies outside the image arrives as zeros. No padded copy, no gather.
//   conv_roll_tma_kernel replaces tools/exp_pallas_conv2.py:_kernel_roll
//     (through conv_roll, pl.pallas_call at exp_pallas_conv2.py:146): the
//     three kx neighbours of a pixel packed along channels, s[j] = (t[j + 1],
//     t[j], t[j - 1]), three products of K = 3 Cin (one per ky) against w
//     packed as (3, 3 Cin, Cout) in kx order (2, 1, 0), one accumulator. Here
//     the copy engine does the packing: a stage holds three sub-tiles, one per
//     third of the packed K, each one TMA box of the same rows at column
//     x0 + 1, x0, x0 - 1. Product ky walks its K over the thirds; the ky
//     offset is whole tile rows, the kx offset lives in the TMA coordinate, so
//     every operand starts on a swizzle pattern. The columns that the TPU
//     kernel's circular roll wraps are never computed.
//   conv_prodroll_tma_kernel replaces tools/exp_pallas_conv2.py:_kernel_prodroll
//     (through conv_prodroll, pl.pallas_call at exp_pallas_conv2.py:197): nine
//     products of unshifted input rows, the kx shift applied to the f32
//     products, once per row after the last chunk. The TPU tool gathers padded
//     row tiles first and keeps o[q] = p0[q] + p1[q + 1] + p2[q + 2] over the
//     padded columns; here one box a stage holds rows y - 1 .. y + 2 of the
//     unpadded x with the strip's halo columns and its zero border, and in
//     image columns the sum is o[q] = p0[q - 1] + p1[q] + p2[q + 1]. Product
//     (ky, kx) reads the box at row offset ky and no column offset and
//     accumulates into acc[kx]: one A descriptor per ky feeds three products.
//   conv_e2_tma_kernel replaces tools/exp_pallas_conv2.py:_kernel_e2 (through
//     conv_e2, pl.pallas_call at exp_pallas_conv2.py:438): the three ky rows
//     packed into channels (K = 3 Cin) against w packed as (3, 3 Cin, Cout)
//     per kx, three products, the same product shift. The copy engine does the
//     packing: three boxes a stage at rows y - 1 + ky, one per third of the
//     packed K (conv_roll's three column-shifted boxes turned by 90 degrees),
//     and product kx walks its K over the thirds into acc[kx]. The TPU
//     kernel's border mask is the boxes' out-of-bounds fill: the products of
//     a zero column are zero.
//   conv_e_tma_kernel replaces tools/exp_pallas_conv2.py:_kernel_e (through
//     conv_e, pl.pallas_call at exp_pallas_conv2.py:352): nine products of
//     unshifted rows of the unpadded x and the kx shift on the f32 products,
//     masked at the image's border (p0 adds nothing into column 0, p2 nothing
//     into column W - 1). The TPU kernel holds a whole-width band and rolls
//     whole products along it; its three band cases (a zero row above the
//     first band, below the last) are the box's out-of-bounds fill here. What
//     it keeps of the whole width: the shift is carried along the row. A
//     warpgroup walks its row's 64-column tiles left to right, each box at
//     image column 64 t with no halo column, and each tile hands the next,
//     in registers, p0 of its last column and its last output column's sum
//     so far; no product is computed twice.
//   conv_band_tma_kernel replaces tools/exp_pallas_conv.py:_kernel (through
//     conv_pallas, pl.pallas_call at exp_pallas_conv.py:93) and
//     conv_dma_tma_kernel tools/exp_pallas_conv2.py:_kernel_dma (through
//     conv_dma, pl.pallas_call at exp_pallas_conv2.py:253), the BAND kind. The
//     TPU kernels copy a band of TH + 2 rows of an x that XLA padded first
//     into a two-slot VMEM buffer (the copy of band i + 1 started in step i)
//     and run the nine taps as windows of the band against a w that stays
//     whole in VMEM; _kernel writes the taps out, _kernel_dma walks them in a
//     loop. Here a band's tile is conv_halo's box of the unpadded x (the zero
//     border is the out-of-bounds fill: no pad), and what is left of the
//     formulation is its other idea, one load of the weights for the whole
//     band: the CL blocks of a thread-block cluster own CL adjacent column
//     strips of the same rows and N tile, and each stage's weights reach all
//     of them by one multicast load, block r of the cluster loading rows
//     [r 72 / CL, (r + 1) 72 / CL) of the stage's 72 rows of 512 bytes into
//     every block. conv_band's consumers write the nine taps out, as
//     conv_halo's do; conv_dma's walk them in a run-time loop.
//
// None is carried over block by block. conv_halo, conv_roll and BAND: a block of
// two consumer warpgroups and one producer warp owns TH rows x OC columns x
// 128 output channels (four 64-row wgmma tiles of 8 columns x 8 rows, two per
// warpgroup: TH x OC = 8 x 32, 16 x 16 or 32 x 8) and walks up to
// BANDS_PER_BLOCK successive row tiles of its column strip, so the ring of
// stages never drains between tiles. One
// stage is (row tile, 16 input channels): the A boxes and the nine taps'
// weights for those channels, (9, 128, 16) K-major. The producer's elected
// lane waits on a stage's empty barrier, posts the stage's bytes on its full
// barrier and starts the loads; the consumers wait on the full barrier, start
// 18 products m64n128k16 each (two tiles x nine taps), wait for them and
// release the stage, one arrival per warp. An 8 x 8-pixel tile is regular
// enough for one descriptor because a tile row's pitch is a multiple of the
// 256-byte swizzle pattern: eight pixels of 32 bytes are one core-matrix
// group, the next group is the next tile row. Halo's windows at kx = 1, 2
// start 32 or 64 bytes into a pattern; the hardware swizzles on absolute
// address bits, so a shifted start address is all they need.
//
// What bounds them on this card: operations (576 FLOP a byte at 128 -> 128,
// above the card's 295). Two things kept the first version from the tensor
// cores' rate, both measured (PERF.md). The copy engine makes one request
// per innermost row of a box, and 16 channels are 32-byte rows: a box of 9 x
// 128 weight rows was 1152 requests a stage and cost a quarter of the time.
// So the wrapper packs each stage's weights contiguously, already in the
// swizzled order, and the map copies them as 72 rows of 512 bytes. The A boxes
// keep their 32-byte rows (400 a stage for halo, 960 for roll, which reads x
// three times over). And the epilogue: 4-byte stores of the accumulator
// layout took a quarter of the time with the tensor cores idle; a quad
// transpose makes them 16-byte stores.
//
// The BAND kind is bound the same way (576 FLOP a byte) and asks the same of
// L2 per stage as conv_halo unless its cluster shares the weights: a stage
// brings 12.8 KB of A and 36.9 KB of weights for 9.4 MFLOP, at the tensor
// cores' rate (~4,096 FLOP a clock an SM) ~21.6 bytes a clock an SM, ~5.2
// TB/s over the card, about where its L2 is reported to saturate. A cluster
// of CL blocks asks L2 for a stage's weights once: 2 blocks cut an SM's bytes
// by 37%, 4 by 56%. What the sharing costs: a slot may be refilled only when
// every block of the cluster has released it (the empty barrier counts
// CONSUMER_WARPS x CL arrivals, each consumer warp arriving on the barrier of
// every block by a remote arrive); each block's full barrier expects its own
// A box and all of the stage's weights, since the peers' slices land in its
// slot and count on its barrier; the grid puts the strips fastest within an N
// tile so that a cluster shares n0, the strips padded to a multiple of CL
// (a block past W loads its box, zeros, joins every barrier and stores
// nothing); a cluster barrier after the barriers' init, before the first
// multicast, and another before exit, so that no block leaves while a peer
// may still write into its shared memory or arrive on its barriers.
// Measured on the H100 (PERF.md §6), the sharing does not pay: the
// loads alone take ~55% of the kernel's time and hide behind the products,
// a slot waits for the slowest block of its cluster, and the card holds 30
// clusters of 4 (120 SMs). So BAND_CL is 1 at every TH, and clusters of 2 and
// 4 are kept as variants to measure against.
//
// conv_prodroll, conv_e2 and conv_e keep three accumulators of unshifted
// products and shift them along the pixels, which an 8 x 8-pixel M tile would
// cut every 8 columns. So their tile is 64 consecutive pixels of one row (64
// rows of 32 bytes, core-matrix groups 256 bytes apart). In prodroll and e2
// it is the M tile: warp w of a warpgroup holds columns 16 w .. 16 w + 15,
// lane 4 g + t columns g and g + 8, so column c + 1 is lane + 4 or the lane's
// own second half (__shfl_sync), and only the three warp boundaries of a tile
// pass a column through shared memory (behind the warpgroup's named
// barrier); e's layout follows below. Three accumulators at N = 64
// are 96 registers a thread; a block is two such tiles, one row per
// warpgroup, x 64 output channels, and walks row pairs. One stage is (two
// rows, 32 input channels), two chunks of 16: 16 KB of A for prodroll and e,
// 24 KB for e2 (x read three times over), 18 products of a warpgroup between
// two waits (one chunk a stage, half as many, was 7-9% slower: PERF.md).
// Their weights, nine K = 16 x 64 slices a chunk, would be 18 KB a chunk more
// than A, too many bytes from L2 for 2.4 MFLOP (90 FLOP a byte); so the
// block's N tile of weights stays in shared memory for the whole walk where
// it fits (9 CINP x 64 x 2 bytes: 144 KB at Cin = 128, CINP = Cin padded to
// 32), loaded chunk by chunk (one bulk copy each) with the first tile's
// stages, as the TPU kernels keep all of w in VMEM. A larger Cin streams each
// stage's weights with its A, as conv_halo does. The consumers wait for a
// stage's products before they release it, as conv_halo's do, and shift,
// round and store a tile once, after its last chunk, with conv_halo's 16-byte
// stores.
//
// prodroll and e2 cut a row into strips: a tile's 64 product columns (image
// columns x0 - 1 .. x0 + 62) give 62 outputs, the strips overlap by 2
// columns (13 strips, 832 product columns at W = 768: 8.3% more products),
// and a block walks 64 rows of one strip. e walks whole rows: a block is one
// N tile and a run of the batch's row pairs (the grid one wave, the pairs
// split evenly), a warpgroup each row's ceil(W / 64) tiles left to right at
// x0 = 64 t (768 product columns at W = 768, the conv's own work). Its
// products are transposed: the weights are wgmma's A operand and the box its
// B, so that a lane holds 16 pixels of two channels, and a pixel's
// neighbours lie in its own registers or in the next lanes of its quad: the
// shift takes 36 shuffles a lane and no shared memory (prodroll's 64 and
// three warp boundaries passed through shared memory behind a barrier).
// Output column x0 + 63 needs p2 of the next tile's column 0: the tile keeps
// p0[63] and p0[62] + p1[63] in registers, and the next tile adds its p2[0]
// to the one and takes the other into its column 0. The outputs leave
// through a staging tile in shared memory (stmatrix transposes the
// accumulator's 8 x 8 blocks into pixel rows), 16 bytes a store: columns
// x0 - 1 .. x0 + 62 of each tile, and column x0 + 63 of a row's last tile
// where the image has it (W a multiple of 64), with no p2 term: that is the
// mask at column W - 1. A first build in prodroll's layout (the carry
// through shared memory, the previous tile's column stored by warp 0) was
// slower than prodroll: its epilogue, which both warpgroups run while the
// tensor cores wait, had grown well past prodroll's (PERF.md).
//
// Plain C interface for ctypes; the entry points return cudaGetLastError(),
// cudaErrorInvalidValue for a shape they do not take, or 1000 + the CUresult
// if a tensor map cannot be encoded.

#include <algorithm>
#include <chrono>

#include "conv_engine.cuh"   // engine::store_words and engine::pack2 (the shift kinds)

using namespace hv;

namespace {

constexpr int KC = 16;                  // input channels per stage: one wgmma K
constexpr int KROW = KC * 2;            // bytes of a pixel's chunk: the swizzle width
constexpr int BN = 128;                 // output channels of a block
constexpr int CONSUMER_WARPS = 8;       // two warpgroups
constexpr int NT = 32 * (CONSUMER_WARPS + 1);
constexpr int BANDS_PER_BLOCK = 8;      // successive row tiles a block walks
constexpr int W_BYTES = 9 * BN * KROW;  // a stage's weights
constexpr int TAP_BYTES = BN * KROW;
// the weights' map copies a stage as W_ROWS rows of W_ROW bf16 (512 bytes)
constexpr int W_ROW = 256, W_ROWS = W_BYTES / (2 * W_ROW);

enum Kind { ROLL, HALO, PRODROLL, E2, E, BAND };

struct Params {
  bf* out;            // (B, H, W, COUT)
  int H, W, COUT, NBANDS, NCHUNKS, NTILES;   // NCHUNKS = CINP / KC, NTILES = NP / BN
  int NSTRIPS;        // BAND: column strips, padded to a multiple of the cluster
};

constexpr int align_up(int v, int a) { return (v + a - 1) / a * a; }

// CL: blocks of a cluster that share each stage's weights (BAND only); LOOP:
// the taps in a run-time loop (conv_dma).
template <int KIND_, int TR_, int TC_, int CL_ = 1, bool LOOP_ = false>
struct Cfg {
  static constexpr int KIND = KIND_, TR = TR_, TC = TC_, CL = CL_;
  static constexpr bool LOOP = LOOP_;
  static_assert(TR * TC == 4, "a block is four wgmma tiles");
  static_assert(CL == 1 || (KIND == BAND && (CL == 2 || CL == 4)),
                "clusters of 2 or 4 blocks, BAND only");
  static constexpr int TH = 8 * TR, OC = 8 * TC;                // rows, output columns
  // staged columns of a box: roll's boxes carry their shift in the
  // coordinate; halo's one box has OC + 2, rounded up so that the pitch stays
  // a multiple of the swizzle pattern
  static constexpr int SC = KIND == ROLL ? OC : OC + 8;
  static constexpr int PITCH = SC * KROW;                       // bytes of a tile row
  static constexpr int BOX_BYTES = (TH + 2) * PITCH;
  static constexpr int NBOX = KIND == ROLL ? 3 : 1;
  static constexpr int SUB_BYTES = align_up(BOX_BYTES, 1024);
  static constexpr int A_BYTES = NBOX * SUB_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
  static constexpr int STAGES = KIND == ROLL ? 3 : 4;
  // bytes a stage's loads deliver into each block: its A, all the weights
  static constexpr unsigned TX = NBOX * BOX_BYTES + W_BYTES;
  static constexpr int W_SLICE = W_ROWS / CL;                   // weight rows a block loads
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 1024;
};

// The producer's lane: one stage per (row tile, chunk), in the consumers' order.
// rank: this block's in its cluster.
template <class C>
__device__ __forceinline__ void produce(const CUtensorMap* tmx, const CUtensorMap* tmw,
                                        const Params& p, unsigned base, unsigned full,
                                        unsigned empty, int x0, int n0, int i0, int nb, int b,
                                        unsigned rank) {
  int st = 0;
  unsigned ph = 0;
  for (int band = i0; band < i0 + nb; ++band) {
    const int y = band * C::TH - 1;
    for (int q = 0; q < p.NCHUNKS; ++q) {
      // BAND: every block of the cluster has released the slot
      mbar_wait(empty + 8 * st, ph ^ 1);
      const unsigned bar = full + 8 * st, a = base + st * C::STAGE_BYTES;
      mbar_expect_tx(bar, C::TX);
      if constexpr (C::KIND == ROLL) {
#pragma unroll
        for (int third = 0; third < 3; ++third)
          tma_load_4d(a + third * C::SUB_BYTES, tmx, bar, q * KC, x0 + 1 - third, y, b);
      } else {
        tma_load_4d(a, tmx, bar, q * KC, x0 - 1, y, b);
      }
      const int wz = q * p.NTILES + n0 / BN;
      if constexpr (C::CL > 1) {
        const int r0 = rank * C::W_SLICE;
        tma_load_3d_multicast(a + C::A_BYTES + r0 * 2 * W_ROW, tmw, bar, 0, r0, wz,
                              (unsigned short)((1u << C::CL) - 1));
      } else {
        tma_load_3d(a + C::A_BYTES, tmw, bar, 0, 0, wz);
      }
      if (++st == C::STAGES) { st = 0; ph ^= 1; }
    }
  }
}

// Round a row tile's accumulator once and store it, masked past W and COUT.
// Accumulator row m of tile (tr, tc) is pixel (8 tr + m / 8, 8 tc + m % 8). A
// lane holds two channels of every eighth: 4-byte stores would fill half a
// 32-byte sector each. So the four lanes of a quad transpose 4 x 4 words
// first (two exchanges), after which lane t holds the eight channels 8 (4 i +
// t) .. + 7 of its pixel and stores them as 16 bytes.
__device__ __forceinline__ void store_tile(const float (&d)[64], const Params& p, int b, int y,
                                           int x, int n0, int lane, int w4) {
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1, hi = t & 2;
  const bool inside = x + g < p.W, wide = (p.COUT & 7) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf* o = p.out + ((size_t)(b * p.H + y + 2 * w4 + half) * p.W + x + g) * p.COUT;
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      unsigned a[4];   // a[s]: channels 8 (4 i + s) + 2 t, + 1
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(d[4 * (4 * i + s) + 2 * half],
                                                       d[4 * (4 * i + s) + 2 * half + 1]);
        a[s] = *reinterpret_cast<const unsigned*>(&v);
      }
      // with lane t ^ 1: rows s = t & 1 of (0, 1) and (2, 3), two words each
      const unsigned r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[1], 1);
      const unsigned r1 = __shfl_xor_sync(0xffffffffu, odd ? a[2] : a[3], 1);
      if (odd) { a[0] = r0; a[2] = r1; } else { a[1] = r0; a[3] = r1; }
      // with lane t ^ 2: row s = t, four words in channel order
      const unsigned q0 = __shfl_xor_sync(0xffffffffu, hi ? a[0] : a[2], 2);
      const unsigned q1 = __shfl_xor_sync(0xffffffffu, hi ? a[1] : a[3], 2);
      if (hi) { a[0] = q0; a[1] = q1; } else { a[2] = q0; a[3] = q1; }
      const int co = n0 + 8 * (4 * i + t);
      if (!inside || co >= p.COUT) continue;
      if (wide) {                       // COUT % 8 == 0: aligned, and co + 8 <= COUT
        *reinterpret_cast<uint4*>(o + co) = make_uint4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (co + e < p.COUT)
            o[co + e] = __ushort_as_bfloat16((unsigned short)(a[e >> 1] >> (16 * (e & 1))));
      }
    }
  }
}

// One tap's two products: this warpgroup's two M tiles at window `win` of the
// stage's A (tile offsets a_off), the tap's weights at w.
template <class C>
__device__ __forceinline__ void tap_products(float (&acc)[2][64], unsigned win,
                                             const unsigned (&a_off)[2], unsigned w,
                                             int scale_d) {
  const uint64_t db = wgmma_desc(w, 8 * KROW, WGMMA_SWIZZLE_32B);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    wgmma_m64n128k16_bf16(acc[mt], wgmma_desc(win + a_off[mt], C::PITCH, WGMMA_SWIZZLE_32B),
                          db, scale_d);
}

template <class C>
__device__ __forceinline__ void consume(const Params& p, unsigned base, unsigned full,
                                        unsigned empty, int x0, int n0, int i0, int nb, int b,
                                        int warp, int lane) {
  const int wg = warp >> 2, w4 = warp & 3;
  // this warpgroup's tiles: 2 wg and 2 wg + 1 of the block's four, row-major
  unsigned a_off[2];
  int ty[2], tx[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int tile = 2 * wg + mt, tr = tile / C::TC, tc = tile % C::TC;
    ty[mt] = 8 * tr;
    tx[mt] = 8 * tc;
    a_off[mt] = ty[mt] * C::PITCH + tx[mt] * KROW;
  }
  float acc[2][64] = {};
  int st = 0;
  unsigned ph = 0;
  for (int band = i0; band < i0 + nb; ++band) {
    for (int q = 0; q < p.NCHUNKS; ++q) {
      mbar_wait(full + 8 * st, ph);
      const unsigned a = base + st * C::STAGE_BYTES, w = a + C::A_BYTES;
      wgmma_fence_acc(acc[0]);
      wgmma_fence_acc(acc[1]);
      wgmma_fence();
      if constexpr (C::LOOP) {
        // the window of tap (ky, kx) at run time: ky whole tile rows, kx
        // pixels. Each iteration opens with its own wgmma.fence; ptxas still
        // injects one warpgroup.arrive for the loop-carried accumulators
        // (C7519, not a serialisation), two without the fence.
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const int ky = tap / 3;
          wgmma_fence();
          tap_products<C>(acc, a + ky * C::PITCH + (tap - 3 * ky) * KROW, a_off,
                          w + tap * TAP_BYTES, q != 0 || tap != 0);
        }
      } else {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int t = 0; t < 3; ++t)
            // roll: third t of the packed K, rows ky ..; halo, band: the window
            // at (ky, kx = t)
            tap_products<C>(acc,
                            a + (C::KIND == ROLL ? t * C::SUB_BYTES + ky * C::PITCH
                                                 : ky * C::PITCH + t * KROW),
                            a_off, w + (3 * ky + t) * TAP_BYTES, q != 0 || ky != 0 || t != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_acc(acc[0]);
      wgmma_fence_acc(acc[1]);
      if (lane == 0) {
        if constexpr (C::CL == 1) {
          mbar_arrive(empty + 8 * st);
        } else {
          // every block's producer multicasts into this slot
#pragma unroll
          for (int r = 0; r < C::CL; ++r) mbar_arrive_cluster(empty + 8 * st, r);
        }
      }
      if (++st == C::STAGES) { st = 0; ph ^= 1; }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      store_tile(acc[mt], p, b, band * C::TH + ty[mt], x0 + tx[mt], n0, lane, w4);
  }
}

// This block: image blockIdx.z, row tiles [BANDS_PER_BLOCK * blockIdx.y, ...),
// column strip and channel tile from blockIdx.x: the channel tile fastest,
// but for BAND the strip fastest within a channel tile, so that the blocks of
// a cluster (consecutive blockIdx.x) share it.
template <class C>
__device__ __forceinline__ void conv_tma(const CUtensorMap* tmx, const CUtensorMap* tmw,
                                         const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bars[2 * C::STAGES];
  // the warp index broadcast from lane 0, so that ptxas sees the roles'
  // branch as warp-uniform: under a branch it must treat as divergent, a
  // warpgroup.arrive that it injects serialises every wgmma of the kernel
  // (C7520; conv_dma's tap loop needs one, PERF.md §6)
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  // every box starts a swizzle pattern: the ring is 1024-byte aligned
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned full = smem_u32(bars), empty = full + 8 * C::STAGES;
  const int bx = blockIdx.x;
  const int n0 = (C::KIND == BAND ? bx / p.NSTRIPS : bx % p.NTILES) * BN;
  const int x0 = (C::KIND == BAND ? bx % p.NSTRIPS : bx / p.NTILES) * C::OC;
  const int i0 = blockIdx.y * BANDS_PER_BLOCK, b = blockIdx.z;
  const int nb = min(BANDS_PER_BLOCK, p.NBANDS - i0);
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS * C::CL);
    }
    mbar_fence_init();
    fence_proxy_async();
  }
  // the peers' barriers are ready before this block multicasts into them
  if constexpr (C::CL > 1) cluster_sync(); else __syncthreads();
  // the two roles never meet again
  if (warp == CONSUMER_WARPS) {
    if (lane == 0)
      produce<C>(tmx, tmw, p, base, full, empty, x0, n0, i0, nb, b,
                 C::CL > 1 ? cluster_rank() : 0u);
  } else {
    consume<C>(p, base, full, empty, x0, n0, i0, nb, b, warp, lane);
  }
  // no block leaves while a peer may still arrive on its barriers
  if constexpr (C::CL > 1) cluster_sync();
}

template <int TR, int TC>
__global__ void __launch_bounds__(NT, 1)
    conv_halo_tma_kernel(const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmw, const Params p) {
  conv_tma<Cfg<HALO, TR, TC>>(&tmx, &tmw, p);
}

template <int TR, int TC>
__global__ void __launch_bounds__(NT, 1)
    conv_roll_tma_kernel(const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmw, const Params p) {
  conv_tma<Cfg<ROLL, TR, TC>>(&tmx, &tmw, p);
}

template <int TR, int TC, int CL>
__global__ void __launch_bounds__(NT, 1)
    conv_band_tma_kernel(const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmw, const Params p) {
  conv_tma<Cfg<BAND, TR, TC, CL>>(&tmx, &tmw, p);
}

template <int TR, int TC, int CL>
__global__ void __launch_bounds__(NT, 1)
    conv_dma_tma_kernel(const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmw, const Params p) {
  conv_tma<Cfg<BAND, TR, TC, CL, true>>(&tmx, &tmw, p);
}

// ---- the product-shift kinds: conv_prodroll, conv_e2 and conv_e -------------

namespace shift {

constexpr int BN = 64;                       // output channels of a block
constexpr int MW = 64;                       // product columns of an M tile: one row
constexpr int OW = MW - 2;                   // prodroll, e2: a strip's output columns
constexpr int ROW_BYTES = MW * KROW;         // one image row of a box: 2 KB
constexpr int TAP_BYTES = BN * KROW;
constexpr int W_BYTES = 9 * TAP_BYTES;       // a chunk's weights: 18 KB
constexpr int ROWS_PER_BLOCK = 64;           // prodroll, e2: rows a block walks, two at a time
constexpr int CPS = 2;                       // chunks of 16 input channels a stage
// prodroll, e2: the columns a tile passes across its warps' boundaries
// through shared memory, per warpgroup and row parity: acc0 at column 15 of
// warp w to warp w + 1, acc2 at column 0 of warp w to warp w - 1; BN
// channels each
constexpr int XB_FLOATS = 2 * 2 * 2 * 3 * BN;
// e: a warpgroup's tile of outputs in shared memory before its stores, image
// columns x0 - 1 .. x0 + 63 (65 pixels of BN channels, 128 bytes each, the
// 16-byte chunks of pixel s at chunk ^ (s & 7): conflict-free both ways)
constexpr int PIX_BYTES = BN * 2, SLOTS = MW + 1, STAGING_BYTES = SLOTS * PIX_BYTES;

struct Params {
  const unsigned char* wk;   // (NCHUNKS, NTILES, 9, BN, 16) bf16, swizzled
  bf* out;                   // (B, H, W, COUT)
  int H, W, COUT, NCHUNKS, NTILES, TH, NBANDS, BPB;   // BPB: bands a block walks
  int resident;              // the block's weights stay in shared memory
  int NTW, PAIRS;            // e: 64-column tiles of a row, row pairs of the batch
};

template <int KIND_>
struct Cfg {
  static constexpr int KIND = KIND_;
  // per chunk, prodroll and e: one box of the rows y - 1 .. y + 2; e2: three
  // boxes of two rows at y - 1, y, y + 1, one per third of the packed K
  static constexpr int NBOX = KIND == E2 ? 3 : 1;
  static constexpr int BOX_BYTES = (KIND == E2 ? 2 : 4) * ROW_BYTES;
  static constexpr int CHUNK_BYTES = NBOX * BOX_BYTES;
  static constexpr int A_BYTES = CPS * CHUNK_BYTES;             // a stage's A: 16 or 24 KB
  static constexpr int STAGES = KIND == E2 ? 3 : 4;
  // e has no warp boundaries to pass, and both warpgroups' staging tiles in
  // dynamic shared memory after the weights
  static constexpr int XB = KIND == E ? 1 : XB_FLOATS;
  static constexpr int EPI_BYTES = KIND == E ? 2 * STAGING_BYTES : 0;
  // dynamic shared memory a block may take beside xbuf and the barriers
  static constexpr int DYN_LIMIT = 232448 - 4 * XB - 256;
  static_assert(KIND == PRODROLL || KIND == E2 || KIND == E, "a product-shift kind");
};

// What a block walks: row pairs [p0, p0 + np) of the batch (pair k: rows 2 k
// and 2 k + 1 of the B H rows in order, so image 2 k / H; warpgroup wg takes
// row 2 k + wg), each row in ntw tiles, tile t's box at image column xc + MW t.
struct Walk {
  int p0, np, ntw, xc;
};

// The producer's lane: one stage per (two rows, tile, CPS chunks), in the
// consumers' order; the weights with the stages of the first tile if they
// stay (chunk q in slot q), else with every stage (in the stage's slots).
template <class C>
__device__ __forceinline__ void produce(const CUtensorMap* tmx, const Params& p, const Walk& w,
                                        unsigned ring, unsigned wbase, unsigned full,
                                        unsigned empty, int ntile) {
  int st = 0;
  unsigned ph = 0;
  for (int i = 0; i < w.np; ++i) {
    const int row = 2 * (w.p0 + i), b = row / p.H, y = row % p.H - 1;
    for (int t = 0; t < w.ntw; ++t) {
      const bool wl = !p.resident || (i == 0 && t == 0);
      const int xc = w.xc + MW * t;
      for (int q = 0; q < p.NCHUNKS; q += CPS) {
        mbar_wait(empty + 8 * st, ph ^ 1);
        const unsigned bar = full + 8 * st, a = ring + st * C::A_BYTES;
        mbar_expect_tx(bar, C::A_BYTES + (wl ? CPS * W_BYTES : 0));
#pragma unroll
        for (int c = 0; c < CPS; ++c) {
#pragma unroll
          for (int k = 0; k < C::NBOX; ++k)
            tma_load_4d(a + c * C::CHUNK_BYTES + k * C::BOX_BYTES, tmx, bar, (q + c) * KC, xc,
                        y + k, b);
          if (wl)
            bulk_load(wbase + (p.resident ? q + c : CPS * st + c) * W_BYTES,
                      p.wk + ((size_t)(q + c) * p.NTILES + ntile) * W_BYTES, W_BYTES, bar);
        }
        if (++st == C::STAGES) { st = 0; ph ^= 1; }
      }
    }
  }
}

// prodroll and e2, a row's tile after its last chunk: o[m] = acc0[m - 1] +
// acc1[m] + acc2[m + 1] at product column m (image column xc + m), rounded
// once, stored for m = 1 .. OW inside the image (the tile's own edge columns
// reach no kept output). Lane 4 g + t of warp w4 holds columns 16 w4 + g
// (acc[.][4 j + e]) and + 8 (acc[.][4 j + 2 + e]), channels 8 j + 2 t + e.
// Column g - 1 is lane - 4, or for g = 0 the previous warp's column 15 (from
// xb); column g + 1 is lane + 4, or for g = 7 that lane's second half; the
// second half's neighbours likewise. Every lane touches the accumulators
// first in code that all lanes run (the shuffles): ptxas serialises every
// wgmma of a kernel whose accumulators are first read on a divergent path.
// xb: this warpgroup's buffer for this row's parity, so that a warp writes
// it again only after the next row's barrier, which every reader of this row
// has passed.
__device__ __forceinline__ void shift_store(float (&acc)[3][BN / 2], float* xb, const Params& p,
                                            int b, int y, int xc, int n0, int lane, int w4,
                                            int wg) {
  const int g = lane >> 2, t = lane & 3;
  const int up = (lane + 4) & 31, dn = (lane + 28) & 31;
  float* to_next = xb;              // acc0 at column 15 of warps 0 .. 2
  float* to_prev = xb + 3 * BN;     // acc2 at column 0 of warps 1 .. 3, at w4 - 1
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i0 = 4 * j + e, i1 = i0 + 2;
      const float a0 = acc[0][i0], a1 = acc[0][i1], c0 = acc[2][i0], c1 = acc[2][i1];
      const float l0 = __shfl_sync(0xffffffffu, a0, dn);
      const float l1 = __shfl_sync(0xffffffffu, a1, dn);
      const float r0 = __shfl_sync(0xffffffffu, c0, up);
      const float r1 = __shfl_sync(0xffffffffu, c1, up);
      acc[1][i0] = (g != 0 ? l0 : 0.f) + acc[1][i0] + (g != 7 ? r0 : r1);
      acc[1][i1] = (g != 0 ? l1 : l0) + acc[1][i1] + (g != 7 ? r1 : 0.f);
      const int n = 8 * j + 2 * t + e;
      if (g == 7 && w4 < 3) to_next[w4 * BN + n] = a1;
      if (g == 0 && w4 > 0) to_prev[(w4 - 1) * BN + n] = c0;
    }
  named_bar_sync(1 + wg, 128);
  // and across the warp boundaries
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * t + e;
      if (g == 0 && w4 > 0) acc[1][4 * j + e] += to_next[(w4 - 1) * BN + n];
      if (g == 7 && w4 < 3) acc[1][4 * j + 2 + e] += to_prev[w4 * BN + n];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * w4 + g + 8 * h, col = xc + m;
    const bool ok = m >= 1 && m <= OW && col < p.W;
    const size_t pix = ok ? (size_t)(b * p.H + y) * p.W + col : 0;
    unsigned wd[BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      wd[j] = engine::pack2(acc[1][4 * j + 2 * h], acc[1][4 * j + 2 * h + 1]);
    engine::store_words<BN / 8>(p.out + pix * p.COUT, wd, n0, p.COUT, ok, t);
  }
}

// e, a row's tile after its last chunk. Its products are transposed (rows the
// block's 64 output channels, columns the tile's 64 pixels), so lane 4 g + t
// of warp w4 holds channels 16 w4 + 8 h + g (acc[.][4 j + 2 h + e]) at
// pixels 8 j + 2 t + e: every neighbour of a pixel lies in the lane's own
// registers or in the lanes t - 1 and t + 1 of its quad, and the shift needs
// no shared memory and no barrier. o[m] = acc0[m - 1] + acc1[m] + acc2[m + 1]
// at pixel m (image column xc + m); acc0[-1] is the previous tile's p0[63]
// (lp: none at image column 0, the mask of p0), the image's last column takes
// nothing of p2 (the mask of p2, applied in the tile that holds the column),
// and o[63] lacks its p2 term, which the next tile's p2[0] completes: kept in
// registers across the row's tiles (carry: p0[63]; part: o[63] so far, of
// lane t = 3). The tile's outputs go to the warpgroup's staging tile at slot
// m + 1 (stmatrix, transposing 8 x 8 blocks into pixel rows), with o[-1] =
// part + p2[0] at slot 0, and from there by 16-byte stores: slot 0 if there
// is a tile on the left, slots 1 .. 63 inside the image, slot 64 in the row's
// last tile where the image has the column. Every lane reads the
// accumulators first in the shuffles, which all lanes run.
__device__ __forceinline__ void walk_store(float (&acc)[3][BN / 2], float (&carry)[2],
                                           float (&part)[2], unsigned stage, const Params& p,
                                           int b, int y, int xc, int n0, int lane, int w4,
                                           int wg) {
  const int g = lane >> 2, t = lane & 3;
  const int lsrc = (lane & ~3) | ((t + 3) & 3), rsrc = (lane & ~3) | ((t + 1) & 3);
  const bool left = xc > 0, last = xc + MW >= p.W;
  const int cut = p.W - 1 - xc;                     // the image's last column, as a pixel
  // the previous tile has stored its slots
  named_bar_sync(1 + wg, 128);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lp = __shfl_sync(0xffffffffu, carry[h], lsrc);
    const float pp = __shfl_sync(0xffffffffu, part[h], lsrc);
    float L[8], R[8], rt[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      L[j] = __shfl_sync(0xffffffffu, acc[0][4 * j + 2 * h + 1], lsrc);
      R[j] = __shfl_sync(0xffffffffu, acc[2][4 * j + 2 * h], rsrc);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      rt[2 * j] = acc[2][4 * j + 2 * h + 1];
      rt[2 * j + 1] = t < 3 ? R[j] : j < 7 ? R[j + 1] : 0.f;
    }
    if (cut < MW - 1) {                             // the image ends in this tile
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (8 * (k >> 1) + 2 * t + (k & 1) == cut) rt[k] = 0.f;
    }
    unsigned wd[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float l0 = t > 0 ? L[j] : j > 0 ? L[j - 1] : left ? lp : 0.f;
      const float o0 = l0 + acc[1][4 * j + 2 * h] + rt[2 * j];
      const float o1 = acc[0][4 * j + 2 * h] + acc[1][4 * j + 2 * h + 1] + rt[2 * j + 1];
      wd[j] = engine::pack2(o0, o1);
      if (j == 7) part[h] = o1;
    }
    carry[h] = acc[0][4 * 7 + 2 * h + 1];
    // pixel rows 8 j + r at slot 8 j + r + 1; lane 8 k + r gives row r of block k
    const int chunk = 2 * w4 + h;
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += 4) {
      const int s = 8 * (j0 + (lane >> 3)) + (lane & 7) + 1;
      stmatrix_x4_trans(stage + s * PIX_BYTES + ((chunk ^ (s & 7)) << 4), wd[j0], wd[j0 + 1],
                        wd[j0 + 2], wd[j0 + 3]);
    }
    if (left && t == 0) {                           // slot 0: o[-1] = part + p2[0]
      const __nv_bfloat16 v = __float2bfloat16_rn(pp + acc[2][2 * h]);
      st_shared_u16(stage + (chunk << 4) + 2 * g, __bfloat16_as_ushort(v));
    }
  }
  named_bar_sync(1 + wg, 128);
  // the slots' 16-byte chunks over the warpgroup: every load first, so that
  // their latencies overlap, then the stores
  constexpr int ITERS = (SLOTS * 8 + 127) / 128;
  const int tid = 32 * w4 + lane;
  const size_t row = (size_t)(b * p.H + y) * p.W;
  uint4 v[ITERS];
  bool ok[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int k = tid + 128 * it, s = k >> 3, c = k & 7, col = xc - 1 + s;
    ok[it] = k < SLOTS * 8 && (s == 0 ? left : col < p.W && (s < MW || last)) &&
             n0 + 8 * c < p.COUT;
    if (ok[it]) v[it] = ld_shared_v4(stage + s * PIX_BYTES + ((c ^ (s & 7)) << 4));
  }
  const bool wide = (p.COUT & 7) == 0;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    if (!ok[it]) continue;
    const int k = tid + 128 * it, s = k >> 3, co = n0 + 8 * (k & 7);
    bf* o = p.out + (row + xc - 1 + s) * p.COUT + co;
    if (wide) {
      *reinterpret_cast<uint4*>(o) = v[it];
    } else {
      const unsigned wv[4] = {v[it].x, v[it].y, v[it].z, v[it].w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (co + e < p.COUT)
          o[e] = __ushort_as_bfloat16((unsigned short)(wv[e >> 1] >> (16 * (e & 1))));
    }
  }
}

// One stage's products: per chunk nine m64n64k16 of this warpgroup, one
// descriptor of x per ky (box row ky + wg of prodroll's and e's box, row wg
// of e2's box ky) for the three kx; w: the stage's first chunk's weights, the
// next chunk's W_BYTES on. prodroll, e2: x the A operand (rows the pixels),
// e: the weights (rows the output channels). Committed as one group.
template <class C>
__device__ __forceinline__ void stage_products(float (&acc)[3][BN / 2], unsigned a, unsigned w,
                                               int q, int wg) {
#pragma unroll
  for (int k = 0; k < 3; ++k) wgmma_fence_acc(acc[k]);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < CPS; ++c)
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const unsigned rows =
          c * C::CHUNK_BYTES + (C::KIND == E2 ? ky * C::BOX_BYTES : ky * ROW_BYTES);
      const uint64_t dx = wgmma_desc(a + rows + wg * ROW_BYTES, 8 * KROW, WGMMA_SWIZZLE_32B);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // prodroll, e: tap 3 ky + kx; e2: [kx][third ky] of the packed K
        const int slice = C::KIND == E2 ? 3 * kx + ky : 3 * ky + kx;
        const uint64_t dw = wgmma_desc(w + c * W_BYTES + slice * TAP_BYTES, 8 * KROW,
                                       WGMMA_SWIZZLE_32B);
        const int scale = q != 0 || c != 0 || ky != 0;
        if constexpr (C::KIND == E)
          Wgmma<BN>::mma(acc[kx], dw, dx, scale);
        else
          Wgmma<BN>::mma(acc[kx], dx, dw, scale);
      }
    }
  wgmma_commit();
}

// The consumers: warpgroup wg computes row 2 k + wg of each pair k, tile by
// tile. Each stage's products are waited for before the stage is released,
// and the accumulators are read only after a tile's last stage: ptxas
// serialises every wgmma of the kernel if a wait or an accumulator's first
// read lies on a path that not every tile takes (a last chunk peeled off, a
// wait_group 1 kept across stages: PERF.md).
template <class C>
__device__ __forceinline__ void consume(const Params& p, const Walk& w, float* xbuf,
                                        unsigned ring, unsigned wbase, unsigned staging,
                                        unsigned full, unsigned empty, int ntile, int warp,
                                        int lane) {
  const int wg = warp >> 2, w4 = warp & 3;
  float acc[3][BN / 2] = {};
  float carry[2] = {}, part[2] = {};          // e: across the tiles of a row
  int st = 0;
  unsigned ph = 0;
  for (int i = 0; i < w.np; ++i) {
    const int row = 2 * (w.p0 + i) + wg, b = row / p.H, y = row % p.H;
    for (int t = 0; t < w.ntw; ++t) {
      for (int q = 0; q < p.NCHUNKS; q += CPS) {
        mbar_wait(full + 8 * st, ph);
        stage_products<C>(acc, ring + st * C::A_BYTES,
                          wbase + (p.resident ? q : CPS * st) * W_BYTES, q, wg);
        wgmma_wait<0>();
#pragma unroll
        for (int k = 0; k < 3; ++k) wgmma_fence_acc(acc[k]);
        if (lane == 0) mbar_arrive(empty + 8 * st);
        if (++st == C::STAGES) { st = 0; ph ^= 1; }
      }
      if constexpr (C::KIND == E)
        walk_store(acc, carry, part, staging + wg * STAGING_BYTES, p, b, y, w.xc + MW * t,
                   ntile * BN, lane, w4, wg);
      else
        shift_store(acc, xbuf + (2 * wg + (i & 1)) * (XB_FLOATS / 4), p, b, y, w.xc, ntile * BN,
                    lane, w4, wg);
    }
  }
}

// This block. prodroll, e2: image blockIdx.z, bands [BPB * blockIdx.y, ...)
// (64 rows), column strip and channel tile from blockIdx.x (channel tile
// fastest: the blocks that read one box run side by side). e: channel tile
// blockIdx.x, the blockIdx.y-th of gridDim.y even runs of the batch's row
// pairs, whole rows.
template <class C>
__device__ __forceinline__ void conv_shift_tma(const CUtensorMap* tmx, const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bars[2 * C::STAGES];
  __shared__ __align__(16) float xbuf[C::XB];
  // the warp index broadcast from lane 0: the roles' branch warp-uniform to
  // ptxas (the tap loop's C7520, PERF.md §6)
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  // every box starts a swizzle pattern: the ring is 1024-byte aligned, and
  // so are its boxes and the weights' slots after it; e's staging tiles
  // follow the weights
  const unsigned ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned wbase = ring + C::STAGES * C::A_BYTES;
  const unsigned staging =
      wbase + (p.resident ? p.NCHUNKS : C::STAGES * CPS) * (unsigned)W_BYTES;
  const unsigned full = smem_u32(bars), empty = full + 8 * C::STAGES;
  int ntile;
  Walk w;
  if constexpr (C::KIND == E) {
    ntile = blockIdx.x;
    w.p0 = (int)((long long)blockIdx.y * p.PAIRS / gridDim.y);
    w.np = (int)((long long)(blockIdx.y + 1) * p.PAIRS / gridDim.y) - w.p0;
    w.ntw = p.NTW;
    w.xc = 0;
  } else {
    ntile = blockIdx.x % p.NTILES;
    const int i0 = blockIdx.y * p.BPB;
    w.p0 = (blockIdx.z * p.H + i0 * p.TH) / 2;
    w.np = min(p.BPB, p.NBANDS - i0) * p.TH / 2;
    w.ntw = 1;
    w.xc = (blockIdx.x / p.NTILES) * OW - 1;
  }
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_fence_init();
    fence_proxy_async();
  }
  __syncthreads();
  if (warp == CONSUMER_WARPS) {
    if (lane == 0) produce<C>(tmx, p, w, ring, wbase, full, empty, ntile);
  } else {
    consume<C>(p, w, xbuf, ring, wbase, staging, full, empty, ntile, warp, lane);
  }
}

}  // namespace shift

__global__ void __launch_bounds__(NT, 1)
    conv_prodroll_tma_kernel(const __grid_constant__ CUtensorMap tmx, const shift::Params p) {
  shift::conv_shift_tma<shift::Cfg<PRODROLL>>(&tmx, p);
}

__global__ void __launch_bounds__(NT, 1)
    conv_e2_tma_kernel(const __grid_constant__ CUtensorMap tmx, const shift::Params p) {
  shift::conv_shift_tma<shift::Cfg<E2>>(&tmx, p);
}

__global__ void __launch_bounds__(NT, 1)
    conv_e_tma_kernel(const __grid_constant__ CUtensorMap tmx, const shift::Params p) {
  shift::conv_shift_tma<shift::Cfg<E>>(&tmx, p);
}

// ---- host ----------------------------------------------------------------

// The packed weights (NCHUNKS, NTILES, 9, BN, KC): a (chunk, tile) block is
// what a stage holds, W_BYTES contiguous, already in the swizzled order. The
// map sees it as W_ROWS rows of 512 bytes and copies it as it is: long rows,
// where a box of BN x 9 rows of 32 bytes would be 1152 requests a stage. A box
// is `rows` of them: all W_ROWS, or one cluster block's slice.
CUresult encode_w(CUtensorMap* map, const void* wk, int nchunks, int np, int rows = W_ROWS) {
  const cuuint64_t dims[3] = {W_ROW, W_ROWS, (cuuint64_t)nchunks * (np / BN)};
  const cuuint64_t strides[2] = {2 * W_ROW, W_BYTES};
  const cuuint32_t box[3] = {W_ROW, (cuuint32_t)rows, 1};
  return encode(map, wk, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

bool bad_shape(int B, int H, int W, int C, int CINP, int COUT, int NP, int TH, bool th32) {
  return B <= 0 || H <= 0 || W <= 0 || (TH != 8 && TH != 16 && !(th32 && TH == 32)) || H % TH ||
         C <= 0 || C % 8 || CINP < C || CINP % KC || COUT <= 0 || NP % BN || NP < COUT;
}

// A launch of C's blocks on `stream`, in clusters of C::CL along x where
// `cluster` (attr: storage for the attribute).
template <class C>
cudaLaunchConfig_t launch_config(dim3 grid, cudaStream_t stream, bool cluster,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C::CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  return cfg;
}

// Clusters of C that the card can hold at once (cudaOccupancyMaxActiveClusters;
// one block an SM), or minus the error.
template <class C, typename K>
int active_clusters(K kernel) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<C>(dim3(C::CL), nullptr, true, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

template <class C, typename K>
int launch(K kernel, const void* x, const void* wk, void* out, int B, int H, int W, int c,
           int CINP, int COUT, int NP, cudaStream_t stream) {
  CUtensorMap tmx, tmw;
  CUresult res = encode_x(&tmx, x, B, H, W, c, C::SC, C::TH + 2);
  if (res == CUDA_SUCCESS) res = encode_w(&tmw, wk, CINP / KC, NP, C::W_SLICE);
  if (res != CUDA_SUCCESS) return 1000 + (int)res;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  if constexpr (C::CL > 1) {
    // once per configuration: a cluster that the card cannot hold is an
    // error, not a smaller cluster
    static const int clusters = active_clusters<C>(kernel);
    if (clusters <= 0) return clusters < 0 ? -clusters : (int)cudaErrorInvalidConfiguration;
  }
  const int nbands = H / C::TH;
  const int nstrips = align_up((W + C::OC - 1) / C::OC, C::CL);
  const Params p{static_cast<bf*>(out), H, W, COUT, nbands, CINP / KC, NP / BN, nstrips};
  const dim3 grid(nstrips * (NP / BN), (nbands + BANDS_PER_BLOCK - 1) / BANDS_PER_BLOCK, B);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<C>(grid, stream, C::CL > 1, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, tmx, tmw, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The BAND kind's cluster at TH = 8, 16, 32: the fastest of 1, 2 and 4 at TH
// = 8 alone (PERF.md §6: 1; sharing the weights saves L2 bytes that were not
// the limit, and a slot waits for the slowest block of its cluster); every
// block holds four M tiles x 128 channels at every TH, so a stage's weights
// feed the same products at each.
constexpr int BAND_CL[3] = {1, 1, 1};

template <bool LOOP, int TR, int TC, int CL>
int band_launch(const void* x, const void* wk, void* out, int B, int H, int W, int C, int CINP,
                int COUT, int NP, cudaStream_t s) {
  if constexpr (LOOP)
    return launch<Cfg<BAND, TR, TC, CL, true>>(conv_dma_tma_kernel<TR, TC, CL>, x, wk, out, B, H,
                                               W, C, CINP, COUT, NP, s);
  else
    return launch<Cfg<BAND, TR, TC, CL>>(conv_band_tma_kernel<TR, TC, CL>, x, wk, out, B, H, W,
                                         C, CINP, COUT, NP, s);
}

// CL 0: BAND_CL's; at TH = 8 also 1, 2 or 4 (the variants it was chosen from).
template <bool LOOP>
int band_forward(const void* x, const void* wk, void* out, int B, int H, int W, int C, int CINP,
                 int COUT, int NP, int TH, int CL, cudaStream_t s) {
  if (bad_shape(B, H, W, C, CINP, COUT, NP, TH, true)) return (int)cudaErrorInvalidValue;
  if (TH == 8) {
    switch (CL ? CL : BAND_CL[0]) {
      case 1: return band_launch<LOOP, 1, 4, 1>(x, wk, out, B, H, W, C, CINP, COUT, NP, s);
      case 2: return band_launch<LOOP, 1, 4, 2>(x, wk, out, B, H, W, C, CINP, COUT, NP, s);
      case 4: return band_launch<LOOP, 1, 4, 4>(x, wk, out, B, H, W, C, CINP, COUT, NP, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (TH == 16) {
    if (CL && CL != BAND_CL[1]) return (int)cudaErrorInvalidValue;
    return band_launch<LOOP, 2, 2, BAND_CL[1]>(x, wk, out, B, H, W, C, CINP, COUT, NP, s);
  }
  if (CL && CL != BAND_CL[2]) return (int)cudaErrorInvalidValue;
  return band_launch<LOOP, 4, 1, BAND_CL[2]>(x, wk, out, B, H, W, C, CINP, COUT, NP, s);
}


// The product-shift kinds: x (B, H, W, C) with C % 8 == 0, wk (CINP / 16, NP /
// 64, 9, 64, 16), CINP % 32 == 0; TH 8 or 16 (the walk is the same whatever
// TH is: the box's out-of-bounds fill is every band's border).
template <class C, typename K>
int launch_shift(K kernel, const void* x, const void* wk, void* out, int B, int H, int W, int Cx,
                 int CINP, int COUT, int NP, int TH, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || (TH != 8 && TH != 16) || H % TH || Cx <= 0 || Cx % 8 ||
      CINP < Cx || CINP % (shift::CPS * KC) || COUT <= 0 || NP % shift::BN || NP < COUT)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmx;
  const CUresult res = encode_x(&tmx, x, B, H, W, Cx, shift::MW, C::BOX_BYTES / shift::ROW_BYTES);
  if (res != CUDA_SUCCESS) return 1000 + (int)res;
  const int nchunks = CINP / KC;
  const size_t kept =
      (size_t)C::STAGES * C::A_BYTES + (size_t)nchunks * shift::W_BYTES + C::EPI_BYTES + 1024;
  const bool resident = kept <= (size_t)C::DYN_LIMIT;
  const size_t smem = resident ? kept
                               : (size_t)C::STAGES * (C::A_BYTES + shift::CPS * shift::W_BYTES) +
                                     C::EPI_BYTES + 1024;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nbands = H / TH, bpb = shift::ROWS_PER_BLOCK / TH, ntiles = NP / shift::BN;
  const int pairs = B * (H / 2);
  const shift::Params p{static_cast<const unsigned char*>(wk), static_cast<bf*>(out), H, W, COUT,
                        nchunks, ntiles, TH, nbands, bpb, resident,
                        (W + shift::MW - 1) / shift::MW, pairs};
  // e: one block an SM in all, a run of row pairs each; prodroll, e2: 64
  // rows of a strip each
  const int runs = std::max(1, std::min(pairs, (sm_count() + ntiles - 1) / ntiles));
  const dim3 grid = C::KIND == E ? dim3(ntiles, runs, 1)
                                 : dim3((W + shift::OW - 1) / shift::OW * ntiles,
                                        (nbands + bpb - 1) / bpb, B);
  kernel<<<grid, NT, smem, stream>>>(tmx, p);
  return (int)cudaGetLastError();
}

#define HV_LAUNCH(KIND, KERNEL, TR, TC) \
  launch<Cfg<KIND, TR, TC>>(KERNEL<TR, TC>, x, wk, out, B, H, W, C, CINP, COUT, NP, s)

}  // namespace

extern "C" {

// x: (B, H, W, C) bf16 as it is, contiguous, 16-byte aligned, C % 8 == 0 (the
// map's strides are multiples of 16 bytes; a chunk's channels past C arrive as
// zeros). wk: (CINP / 16, NP / 128, 9, 128, 16) bf16, [chunk][tile][3 ky +
// kx][n][k] with the halves of row n exchanged where n & 4, CINP = C padded to
// 16, NP = COUT padded to 128, zeros in the padding. out: (B, H, W, COUT)
// bf16. TH: 8, 16 or 32, H % TH == 0.
int conv_halo_forward_bf16(const void* x, const void* wk, void* out, int B, int H, int W, int C,
                           int CINP, int COUT, int NP, int TH, void* stream) {
  if (bad_shape(B, H, W, C, CINP, COUT, NP, TH, true)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (TH == 8) return HV_LAUNCH(HALO, conv_halo_tma_kernel, 1, 4);
  if (TH == 16) return HV_LAUNCH(HALO, conv_halo_tma_kernel, 2, 2);
  return HV_LAUNCH(HALO, conv_halo_tma_kernel, 4, 1);
}

// As above with wk [chunk][tile][3 ky + third][n][k], third = 2 - kx; TH: 8
// or 16.
int conv_roll_forward_bf16(const void* x, const void* wk, void* out, int B, int H, int W, int C,
                           int CINP, int COUT, int NP, int TH, void* stream) {
  if (bad_shape(B, H, W, C, CINP, COUT, NP, TH, false)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (TH == 8) return HV_LAUNCH(ROLL, conv_roll_tma_kernel, 1, 4);
  return HV_LAUNCH(ROLL, conv_roll_tma_kernel, 2, 2);
}

// conv_band (taps unrolled) and conv_dma (taps in a loop): operands as for
// conv_halo; TH: 8, 16 or 32; the cluster is BAND_CL's.
int conv_band_forward_bf16(const void* x, const void* wk, void* out, int B, int H, int W, int C,
                           int CINP, int COUT, int NP, int TH, void* stream) {
  return band_forward<false>(x, wk, out, B, H, W, C, CINP, COUT, NP, TH, 0,
                             static_cast<cudaStream_t>(stream));
}

int conv_dma_forward_bf16(const void* x, const void* wk, void* out, int B, int H, int W, int C,
                          int CINP, int COUT, int NP, int TH, void* stream) {
  return band_forward<true>(x, wk, out, B, H, W, C, CINP, COUT, NP, TH, 0,
                            static_cast<cudaStream_t>(stream));
}

// Either of them (LOOP: conv_dma) in a cluster of CL blocks: 1, 2 or 4 at TH
// = 8, BAND_CL's at 16 and 32. For timing the variants side by side.
int conv_band_variant_forward_bf16(const void* x, const void* wk, void* out, int B, int H, int W,
                                   int C, int CINP, int COUT, int NP, int TH, int CL, int LOOP,
                                   void* stream) {
  if (CL <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return LOOP ? band_forward<true>(x, wk, out, B, H, W, C, CINP, COUT, NP, TH, CL, s)
              : band_forward<false>(x, wk, out, B, H, W, C, CINP, COUT, NP, TH, CL, s);
}

// The cluster conv_band and conv_dma launch at band height TH, 0 for another TH.
int conv_band_cluster(int TH) {
  return TH == 8 ? BAND_CL[0] : TH == 16 ? BAND_CL[1] : TH == 32 ? BAND_CL[2] : 0;
}

// How many clusters of CL conv_band blocks at TH = 8 the card holds at once,
// or minus the error.
int conv_band_active_clusters(int CL) {
  if (CL == 1) return active_clusters<Cfg<BAND, 1, 4, 1>>(conv_band_tma_kernel<1, 4, 1>);
  if (CL == 2) return active_clusters<Cfg<BAND, 1, 4, 2>>(conv_band_tma_kernel<1, 4, 2>);
  if (CL == 4) return active_clusters<Cfg<BAND, 1, 4, 4>>(conv_band_tma_kernel<1, 4, 4>);
  return -(int)cudaErrorInvalidValue;
}

// x as for conv_halo; wk: (CINP / 16, NP / 64, 9, 64, 16) bf16, [chunk][tile][3
// ky + kx][n][k], swizzled as above, CINP = C padded to 32, NP = COUT padded
// to 64. TH: 8 or 16.
int conv_prodroll_forward_bf16(const void* x, const void* wk, void* out, int B, int H, int W,
                               int C, int CINP, int COUT, int NP, int TH, void* stream) {
  return launch_shift<shift::Cfg<PRODROLL>>(conv_prodroll_tma_kernel, x, wk, out, B, H, W, C,
                                            CINP, COUT, NP, TH,
                                            static_cast<cudaStream_t>(stream));
}

// As conv_prodroll with wk [chunk][tile][3 kx + ky][n][k] (w packed as (3, 3
// Cin, Cout) per kx, [kx][ky Cin + c], chunked along c).
int conv_e2_forward_bf16(const void* x, const void* wk, void* out, int B, int H, int W, int C,
                         int CINP, int COUT, int NP, int TH, void* stream) {
  return launch_shift<shift::Cfg<E2>>(conv_e2_tma_kernel, x, wk, out, B, H, W, C, CINP, COUT,
                                      NP, TH, static_cast<cudaStream_t>(stream));
}

// As conv_prodroll, operands and all.
int conv_e_forward_bf16(const void* x, const void* wk, void* out, int B, int H, int W, int C,
                        int CINP, int COUT, int NP, int TH, void* stream) {
  return launch_shift<shift::Cfg<E>>(conv_e_tma_kernel, x, wk, out, B, H, W, C, CINP, COUT, NP,
                                     TH, static_cast<cudaStream_t>(stream));
}

// Microseconds the host takes to encode one call's two tensor maps (the x map
// of conv_halo at TH = 8 and the weights' map), the mean of `iters`
// encodings; negative if an encoding fails.
double conv_tma_encode_us(const void* x, const void* wk, int B, int H, int W, int C, int CINP,
                          int NP, int iters) {
  CUtensorMap tmx, tmw;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (encode_x(&tmx, x, B, H, W, C, 40, 10) != CUDA_SUCCESS ||
        encode_w(&tmw, wk, CINP / KC, NP) != CUDA_SUCCESS)
      return -1.0;
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / (iters > 0 ? iters : 1);
}

}  // extern "C"
