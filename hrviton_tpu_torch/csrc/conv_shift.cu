// The masked product-shift formulation of the 3x3 stride-1 pad-1 convolution
// experiment for Hopper (sm_90a): a kernel that computes the same conv as the
// kernels of csrc/conv_tma.cu (bf16 in, f32 accumulation over all nine taps
// and all of Cin, one rounding to bf16, no bias, no activation) and realises
// the kx shift of the taps on the f32 products. The other three shift formulations
// read x by TMA and multiply on wgmma in csrc/conv_tma.cu: conv_roll packs
// the kx neighbours into channels, conv_prodroll and conv_e2 shift their
// products as this kernel does, with the ky offset in the box's rows or in
// the packed channels.
//
//   conv_e_kernel replaces _kernel_e (tools/exp_pallas_conv2.py, conv_e, call
//     :352): nine unshifted products and the product shift,
//     o[q] = p0[q - 1] + p1[q] + p2[q + 1], on the unpadded x. The band copy
//     has the TPU kernel's three cases (first band: slot row 0 is zero; last
//     band: slot row TH + 1 is zero; a one-band image is both), no column
//     outside the image is read, and the contributions of p0 to the image's
//     first column and of p2 to its last are masked to zero.
//
// It is not carried over block by block. The TPU kernel holds a whole-width
// tile in fast memory and rotates whole products along the width. Here a
// block of 8 warps owns TH rows x MW = 16 MT product columns x 32 output
// channels and walks Cin in chunks of 32 through a double buffer filled by
// cp.async, over up to 8 successive bands of one image (blocks run in no
// order, and the prefetch of band i + 1 has to live inside one block). A warp
// owns R = TH / 8 full rows, so a product's neighbour along the width is
// always in the same warp.
//
// The product shift is a shift along the M axis of the m16n8 accumulator: a
// lane 4 g + t holds columns g and g + 8 of a 16-column tile, so column c + 1
// is lane + 4, or the lane's own second half (g = 7), or the next tile's first
// half. The kernel keeps one accumulator set per kx through the whole K loop,
// unshifted, and shifts once per band in the epilogue with __shfl_sync; it
// sums the TPU kernel's f32 terms in another order. A block's products at MW
// columns give MW - 2 outputs, so it does MW / (MW - 2) of the conv's work:
// 32 / 30 at TH = 8 (R = 1, MT = 2), 16 / 14 at TH = 16 (R = 2, MT = 1); three
// accumulator sets are 96 registers either way. What the shift buys: one
// ldmatrix of an A fragment feeds the mma's of three taps.
//
// What bounds it on this card: operations (576 FLOP a byte at 128 -> 128,
// above the card's 295). It runs on mma.sync, not wgmma; its times stand
// beside the bound in PERF.md.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError().

#include "mma_utils.cuh"

using namespace hv;

namespace {

constexpr int NT = 256;                 // threads of a block: 8 warps
constexpr int KC = 32;                  // input channels per chunk
constexpr int AS = KC + 8;              // staged pixel stride: ldmatrix rows on distinct banks
constexpr int NF = 2;
constexpr int NCOL = 16 * NF;           // output channels of a block
constexpr int LDB = NCOL + 8;           // staged weight row stride
constexpr int WROWS = 9 * KC;           // staged weight rows of a chunk
constexpr int BPB = 8;                  // successive bands a block walks

struct Params {
  const bf* x;        // the image (B, H, W, C)
  const bf* wk;       // (9, CINP, NP), tap 3 ky + kx, zeros past Cin and COUT
  bf* out;            // (B, H, W, COUT)
  int H, W, C, CINP, COUT, NP, NBANDS;
};

template <int R_, int MT_>
struct Cfg {
  static constexpr int R = R_, MT = MT_;
  static constexpr int TH = 8 * R, MW = 16 * MT;              // rows, product columns
  static constexpr int NACC = 3;                              // accumulator sets (one per kx)
  static constexpr int OW = MW - 2;                           // output columns
  static constexpr int A_ELEMS = (TH + 2) * MW * AS;
  static constexpr int SLOT = A_ELEMS + WROWS * LDB;          // elements of one slot
};

// One step's input into a slot: channels [q * KC, (q + 1) * KC) of the band's
// (TH + 2) x MW pixels. What the image does not have arrives as zeros.
template <class C>
__device__ __forceinline__ void stage_input(bf* A, const Params& p, const bf* img, int band,
                                            int x0, int q, int tid) {
  constexpr int N8 = KC / 8, TH = C::TH, MW = C::MW;
  // slot rows that x has: first band TH + 1 rows into slot rows 1 .., middle
  // band TH + 2, last band TH + 1 into rows 0 ..; the missing row is zero
  const int r_lo = band == 0 ? 1 : 0;
  const int r_hi = band == p.NBANDS - 1 ? TH + 1 : TH + 2;
  const long long row0 = (long long)band * TH - 1;     // row of x at slot row 0
  for (int i = tid; i < (TH + 2) * MW * N8; i += NT) {
    const int s = i % N8, pix = i / N8;
    const int rr = pix / MW, c = pix % MW;
    const int gc = x0 - 1 + c, ch = q * KC + s * 8;
    // a column that x does not have is never read: the same predicate fills
    // it with zeros (a branch that skipped it made the kernels 5-13% slower).
    // Its products reach no kept output anyway: the epilogue masks the
    // image's border columns
    const bool ok = rr >= r_lo && rr < r_hi && gc >= 0 && gc < p.W && ch < p.C;
    const bf* src = ok ? img + ((row0 + rr) * p.W + gc) * p.C + ch : p.x;
    cp_async16_zfill(A + (rr * MW + c) * AS + s * 8, src, ok);
  }
}

// One step's weights: rows [q * KC, (q + 1) * KC) of each of the nine taps,
// output channels [n0, n0 + NCOL); staged row tap * KC + k.
__device__ __forceinline__ void stage_weights(bf* Bs, const Params& p, int q, int n0, int tid) {
  constexpr int SEGS = NCOL / 8;
  for (int i = tid; i < WROWS * SEGS; i += NT) {
    const int s = i % SEGS, row = i / SEGS;
    const int tap = row / KC, k = row % KC;
    cp_async16(Bs + row * LDB + s * 8,
               p.wk + (size_t)(tap * p.CINP + q * KC + k) * p.NP + n0 + s * 8);
  }
}

// The A fragments of a warp's R rows x MT column tiles at one k-slice.
template <int R, int MT>
__device__ __forceinline__ void load_a(unsigned (&fa)[R][MT][4], const bf* a, int row_elems,
                                       int tile_elems) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm_x4(fa[r][mt], a + r * row_elems + mt * tile_elems);
}

// acc += fa x the 16 x NCOL weights at b. acc[r][j][mt][.]: row r, output
// channels 8 j .. 8 j + 7, column tile mt, in the m16n8 accumulator layout
// (lane = 4 g + t: [0], [1] at column 16 mt + g, channels 2 t, 2 t + 1; [2],
// [3] at column 16 mt + g + 8).
template <int R, int MT>
__device__ __forceinline__ void mma_slice(float (&acc)[R][2 * NF][MT][4],
                                          const unsigned (&fa)[R][MT][4], const bf* b) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    unsigned fb[4];
    ldsm_x4_t(fb, b + f * 16);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[r][2 * f][mt], fa[r][mt], fb[0], fb[1]);
        mma_bf16(acc[r][2 * f + 1][mt], fa[r][mt], fb[2], fb[3]);
      }
  }
}

// The products of a staged chunk. No operand is shifted along the width.
template <class C>
__device__ __forceinline__ void products(float (&acc)[C::NACC][C::R][2 * NF][C::MT][4],
                                         const bf* A, const bf* Bs, int warp, int lane) {
  constexpr int R = C::R, MT = C::MT, MW = C::MW;
  // A: 16 columns of a row (one per lane % 16), k-half by lane / 16
  const bf* a_lane = A + (warp * R * MW + (lane & 15)) * AS + (lane >> 4) * 8;
  // B: rows k (one per lane % 16), channel half by lane / 16
  const bf* b_lane = Bs + (lane & 15) * LDB + (lane >> 4) * 8;
  unsigned fa[R][MT][4];
  // nine products of unshifted rows: one A fragment feeds the three kx taps
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      load_a<R, MT>(fa, a_lane + ky * MW * AS + kk, MW * AS, 16 * AS);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        mma_slice<R, MT>(acc[kx], fa, b_lane + ((3 * ky + kx) * KC + kk) * LDB);
    }
}

// s[c] = v[c + 1] along a row's MT column tiles; the last column gets 0.
template <int MT>
__device__ __forceinline__ void shift_up(const float (&v)[MT][4], float (&s)[MT][4], int lane) {
  const int src = (lane + 4) & 31;
  const bool last = (lane >> 2) == 7;          // g = 7: the neighbour is a first half
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float lo = __shfl_sync(0xffffffffu, v[mt][e], src);
      const float hi = __shfl_sync(0xffffffffu, v[mt][2 + e], src);
      const float nx = mt + 1 < MT ? __shfl_sync(0xffffffffu, v[mt + 1 < MT ? mt + 1 : mt][e], src)
                                   : 0.f;
      s[mt][e] = last ? hi : lo;
      s[mt][2 + e] = last ? nx : hi;
    }
}

// s[c] = v[c - 1]; the first column gets 0.
template <int MT>
__device__ __forceinline__ void shift_down(const float (&v)[MT][4], float (&s)[MT][4], int lane) {
  const int src = (lane - 4) & 31;
  const bool first = (lane >> 2) == 0;         // g = 0: the neighbour is a second half
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float lo = __shfl_sync(0xffffffffu, v[mt][e], src);
      const float hi = __shfl_sync(0xffffffffu, v[mt][2 + e], src);
      const float pv = mt > 0 ? __shfl_sync(0xffffffffu, v[mt > 0 ? mt - 1 : mt][2 + e], src)
                              : 0.f;
      s[mt][e] = first ? pv : lo;
      s[mt][2 + e] = first ? lo : hi;
    }
}

// A band's epilogue: shift and add the per-kx products, round once, store
// masked past the block's output columns, W and COUT; leaves the accumulators
// zero for the next band.
template <class C>
__device__ __forceinline__ void epilogue(float (&acc)[C::NACC][C::R][2 * NF][C::MT][4],
                                         const Params& p, int b, int y0, int x0, int n0,
                                         int warp, int lane) {
  constexpr int R = C::R, MT = C::MT;
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (p.COUT & 1) == 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bf* orow = p.out + (size_t)(b * p.H + y0 + warp * R + r) * p.W * p.COUT;
#pragma unroll
    for (int j = 0; j < 2 * NF; ++j) {
      // o[c] = p0[c - 1] + p1[c] + p2[c + 1]; nothing lies left of the
      // image's first column or right of its last
      float o[MT][4], lf[MT][4], rg[MT][4];
      shift_down<MT>(acc[0][r][j], lf, lane);
      shift_up<MT>(acc[2][r][j], rg, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gx = x0 - 1 + 16 * mt + g + 8 * (e >> 1);
          o[mt][e] = acc[1][r][j][mt][e] + (gx == 0 ? 0.f : lf[mt][e]) +
                     (gx == p.W - 1 ? 0.f : rg[mt][e]);
        }
      const int co = n0 + j * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int k = 0; k < C::NACC; ++k) {
            acc[k][r][j][mt][2 * half] = 0.f;
            acc[k][r][j][mt][2 * half + 1] = 0.f;
          }
          const int c = 16 * mt + g + 8 * half;         // product column of the block
          const int oc = c - 1;                         // output column of the block
          const int gx = x0 + oc;
          if (oc < 0 || oc >= C::OW || gx >= p.W) continue;
          const float v0 = o[mt][2 * half], v1 = o[mt][2 * half + 1];
          bf* dst = orow + (size_t)gx * p.COUT;
          if (pairs && co + 1 < p.COUT) {
            *reinterpret_cast<__nv_bfloat162*>(dst + co) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (co < p.COUT) dst[co] = from_f<bf>(v0);
            if (co + 1 < p.COUT) dst[co + 1] = from_f<bf>(v1);
          }
        }
    }
  }
}

// This block: image blockIdx.z, bands [BPB * blockIdx.y, ...), output columns
// and channel tile from blockIdx.x (channel tile fastest, so blocks that share
// an input piece are neighbours and find it in L2). One step of the double
// buffer is (band, chunk).
template <class C>
__device__ __forceinline__ void shift_conv(const Params& p, bf* slots) {
  constexpr int TH = C::TH, SLOT = C::SLOT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nct = p.NP / NCOL;
  const int n0 = (blockIdx.x % nct) * NCOL, x0 = (blockIdx.x / nct) * C::OW;
  const int i0 = blockIdx.y * BPB, b = blockIdx.z;
  const int nb = min(BPB, p.NBANDS - i0);
  const int nchunks = p.CINP / KC;
  const int steps = nb * nchunks;
  const bf* img = p.x + (size_t)b * p.H * p.W * p.C;
  float acc[C::NACC][C::R][2 * NF][C::MT][4] = {};

  stage_input<C>(slots, p, img, i0, x0, 0, tid);
  stage_weights(slots + C::A_ELEMS, p, 0, n0, tid);
  cp_async_commit();
  int band = i0, q = 0;                  // of step s
  for (int s = 0; s < steps; ++s) {
    int band_n = band, q_n = q + 1;      // of step s + 1
    if (q_n == nchunks) { q_n = 0; ++band_n; }
    if (s + 1 < steps) {
      // the other slot was read in step s - 1; the barrier that ended that
      // step lets this copy overwrite it
      bf* nxt = slots + ((s + 1) & 1) * SLOT;
      stage_input<C>(nxt, p, img, band_n, x0, q_n, tid);
      stage_weights(nxt + C::A_ELEMS, p, q_n, n0, tid);
      cp_async_commit();
      cp_async_wait<1>();                // step s has landed; s + 1 is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf* A = slots + (s & 1) * SLOT;
    products<C>(acc, A, A + C::A_ELEMS, warp, lane);
    if (q == nchunks - 1) epilogue<C>(acc, p, b, band * TH, x0, n0, warp, lane);
    __syncthreads();
    band = band_n;
    q = q_n;
  }
}

template <int R, int MT>
__global__ void __launch_bounds__(NT) conv_e_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  shift_conv<Cfg<R, MT>>(p, reinterpret_cast<bf*>(smem_raw));
}

template <class C, typename K>
cudaError_t launch(K kernel, const Params& p, int B, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)C::SLOT * sizeof(bf);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.W + C::OW - 1) / C::OW * (p.NP / NCOL), (p.NBANDS + BPB - 1) / BPB, B);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, H, W, C) bf16 as it is, C % 8 == 0 (a chunk's channels past C are
// zero-filled by the kernel); wk: (9, CINP, NP), tap 3 ky + kx, CINP = C
// padded to 32, NP = COUT padded to a multiple of 32. out: (B, H, W, COUT)
// bf16. TH: 8 or 16, H % TH == 0.
int conv_e_forward_bf16(const void* x, const void* wk, void* out, int B, int H, int W, int C,
                        int CINP, int COUT, int NP, int TH, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || (TH != 8 && TH != 16) || H % TH || C <= 0 || C % 8 ||
      CINP < C || CINP % KC || COUT <= 0 || NP % NCOL || NP < COUT)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const bf*>(x), static_cast<const bf*>(wk), static_cast<bf*>(out),
                 H, W, C, CINP, COUT, NP, H / TH};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(TH == 8 ? launch<Cfg<1, 2>>(conv_e_kernel<1, 2>, p, B, s)
                       : launch<Cfg<2, 1>>(conv_e_kernel<2, 1>, p, B, s));
}

}  // extern "C"
