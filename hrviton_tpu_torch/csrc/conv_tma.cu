// Two formulations of the 3x3 stride-1 pad-1 convolution experiment designed
// for Hopper's asynchronous units (sm_90a): the input tile with its halo and
// its zero border arrives by TMA straight from the unpadded x, and the
// products run on wgmma. Both compute what the kernels of csrc/conv_exp.cu and
// csrc/conv_shift.cu compute (bf16 in, f32 accumulation over all nine taps
// and all of Cin, one rounding to bf16, no bias, no activation).
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
//
// Neither is carried over block by block. A block of two consumer warpgroups
// and one producer warp owns TH rows x OC columns x 128 output channels (four
// 64-row wgmma tiles of 8 columns x 8 rows, two per warpgroup: TH x OC = 8 x
// 32, 16 x 16 or 32 x 8) and walks up to BANDS_PER_BLOCK successive row tiles
// of its column strip, so the ring of stages never drains between tiles. One
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
// Plain C interface for ctypes; the entry points return cudaGetLastError(),
// cudaErrorInvalidValue for a shape they do not take, or 1000 + the CUresult
// if a tensor map cannot be encoded.

#include <chrono>

#include "mma_utils.cuh"
#include "tma_wgmma.cuh"

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

enum Kind { ROLL, HALO };

struct Params {
  bf* out;            // (B, H, W, COUT)
  int H, W, COUT, NBANDS, NCHUNKS, NTILES;   // NCHUNKS = CINP / KC, NTILES = NP / BN
};

constexpr int align_up(int v, int a) { return (v + a - 1) / a * a; }

template <int KIND_, int TR_, int TC_>
struct Cfg {
  static constexpr int KIND = KIND_, TR = TR_, TC = TC_;
  static_assert(TR * TC == 4, "a block is four wgmma tiles");
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
  static constexpr unsigned TX = NBOX * BOX_BYTES + W_BYTES;    // bytes a stage's loads deliver
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 1024;
};

// The producer's lane: one stage per (row tile, chunk), in the consumers' order.
template <class C>
__device__ __forceinline__ void produce(const CUtensorMap* tmx, const CUtensorMap* tmw,
                                        const Params& p, unsigned base, unsigned full,
                                        unsigned empty, int x0, int n0, int i0, int nb, int b) {
  int st = 0;
  unsigned ph = 0;
  for (int band = i0; band < i0 + nb; ++band) {
    const int y = band * C::TH - 1;
    for (int q = 0; q < p.NCHUNKS; ++q) {
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
      tma_load_3d(a + C::A_BYTES, tmw, bar, 0, 0, q * p.NTILES + n0 / BN);
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
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          // roll: third t of the packed K, rows ky ..; halo: the window at (ky, kx = t)
          const unsigned win = C::KIND == ROLL ? t * C::SUB_BYTES + ky * C::PITCH
                                               : ky * C::PITCH + t * KROW;
          const uint64_t db = wgmma_desc(w + (3 * ky + t) * TAP_BYTES, 8 * KROW,
                                         WGMMA_SWIZZLE_32B);
          const int scale_d = q != 0 || ky != 0 || t != 0;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            wgmma_m64n128k16_bf16(acc[mt],
                                  wgmma_desc(a + win + a_off[mt], C::PITCH, WGMMA_SWIZZLE_32B),
                                  db, scale_d);
        }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_acc(acc[0]);
      wgmma_fence_acc(acc[1]);
      if (lane == 0) mbar_arrive(empty + 8 * st);
      if (++st == C::STAGES) { st = 0; ph ^= 1; }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      store_tile(acc[mt], p, b, band * C::TH + ty[mt], x0 + tx[mt], n0, lane, w4);
  }
}

// This block: image blockIdx.z, row tiles [BANDS_PER_BLOCK * blockIdx.y, ...),
// column strip and channel tile from blockIdx.x (channel tile fastest).
template <class C>
__device__ __forceinline__ void conv_tma(const CUtensorMap* tmx, const CUtensorMap* tmw,
                                         const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bars[2 * C::STAGES];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // every box starts a swizzle pattern: the ring is 1024-byte aligned
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned full = smem_u32(bars), empty = full + 8 * C::STAGES;
  const int n0 = (blockIdx.x % p.NTILES) * BN, x0 = (blockIdx.x / p.NTILES) * C::OC;
  const int i0 = blockIdx.y * BANDS_PER_BLOCK, b = blockIdx.z;
  const int nb = min(BANDS_PER_BLOCK, p.NBANDS - i0);
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_fence_init();
    fence_proxy_async();
  }
  __syncthreads();
  // the two roles never meet again
  if (warp == CONSUMER_WARPS) {
    if (lane == 0) produce<C>(tmx, tmw, p, base, full, empty, x0, n0, i0, nb, b);
  } else {
    consume<C>(p, base, full, empty, x0, n0, i0, nb, b, warp, lane);
  }
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

// ---- host ----------------------------------------------------------------

// The packed weights (NCHUNKS, NTILES, 9, BN, KC): a (chunk, tile) block is
// what a stage holds, W_BYTES contiguous, already in the swizzled order. The
// map sees it as W_ROWS rows of 512 bytes and copies it as it is: long rows,
// where a box of BN x 9 rows of 32 bytes would be 1152 requests a stage.
constexpr int W_ROW = 256, W_ROWS = W_BYTES / (2 * W_ROW);
CUresult encode_w(CUtensorMap* map, const void* wk, int nchunks, int np) {
  const cuuint64_t dims[3] = {W_ROW, W_ROWS, (cuuint64_t)nchunks * (np / BN)};
  const cuuint64_t strides[2] = {2 * W_ROW, W_BYTES};
  const cuuint32_t box[3] = {W_ROW, W_ROWS, 1};
  return encode(map, wk, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

bool bad_shape(int B, int H, int W, int C, int CINP, int COUT, int NP, int TH, bool th32) {
  return B <= 0 || H <= 0 || W <= 0 || (TH != 8 && TH != 16 && !(th32 && TH == 32)) || H % TH ||
         C <= 0 || C % 8 || CINP < C || CINP % KC || COUT <= 0 || NP % BN || NP < COUT;
}

template <class C, typename K>
int launch(K kernel, const void* x, const void* wk, void* out, int B, int H, int W, int c,
           int CINP, int COUT, int NP, cudaStream_t stream) {
  CUtensorMap tmx, tmw;
  CUresult res = encode_x(&tmx, x, B, H, W, c, C::SC, C::TH + 2);
  if (res == CUDA_SUCCESS) res = encode_w(&tmw, wk, CINP / KC, NP);
  if (res != CUDA_SUCCESS) return 1000 + (int)res;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nbands = H / C::TH;
  Params p{static_cast<bf*>(out), H, W, COUT, nbands, CINP / KC, NP / BN};
  const dim3 grid((W + C::OC - 1) / C::OC * (NP / BN),
                  (nbands + BANDS_PER_BLOCK - 1) / BANDS_PER_BLOCK, B);
  kernel<<<grid, NT, C::SMEM, stream>>>(tmx, tmw, p);
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
