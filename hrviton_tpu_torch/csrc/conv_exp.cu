// The staging formulations of the 3x3 stride-1 pad-1 convolution experiment
// for Hopper (sm_90a): two kernels that compute the same conv (bf16 in, f32
// accumulation over all nine taps and all of Cin, one rounding to bf16, no
// bias, no activation) from a pre-padded input. (The third staging
// formulation, conv_halo, reads the unpadded x by TMA: csrc/conv_tma.cu.)
//
//   conv_band_kernel replaces the TPU kernel tools/exp_pallas_conv.py:_kernel
//     (reached through conv_pallas, whose pl.pallas_call is at
//     exp_pallas_conv.py:93): pre-padded input, row bands through a double
//     buffer filled by asynchronous copies, the nine taps unrolled at compile
//     time (immediate shared-memory offsets).
//   conv_dma_kernel replaces tools/exp_pallas_conv2.py:_kernel_dma (through
//     conv_dma, pl.pallas_call at exp_pallas_conv2.py:253): the same band
//     double buffer, the nine taps in a run-time loop with computed offsets.
//
// None is carried over block by block. The TPU kernels hold a whole-width
// band (2 x (TH + 2) x Wp x 128, megabytes) in fast memory and start the
// copy of band i + 1 in grid step i, relying on a grid that runs in order on
// one core. Here a block has at most 227 KB and blocks run in no order, so
// the prefetch lives inside one block: a block owns a 16-pixel column
// segment and 64 output channels, walks up to BANDS_PER_BLOCK successive
// bands of one image itself, and walks Cin in chunks of 32. One step of the
// double buffer is (band, chunk): cp.async fills one slot with the chunk's
// (TH + 2) x 18 input pixels and its 9 x 32 x 64 weights while ldmatrix +
// mma.sync (m16n8k16) read the other. A warp owns TH / 8 rows of the band, so
// a B fragment feeds TH / 8 row tiles and a larger TH amortises both the
// weight traffic and the halo rows. The input is padded by the caller (rows,
// columns to Wp = W + 2 rounded up to 8, channels to 32), so the kernels test
// no border; columns at or past Wp are not copied and only feed masked
// outputs.
//
// What bounds them on this card: operations. At 128 -> 128 a pixel needs
// 295 KFLOP against 512 bytes, 576 FLOP a byte, above the card's 295. The
// kernels re-read a halo ((TH + 2) / TH rows, 18 / 16 columns) and one chunk
// of weights per step from L2, and run on mma.sync, not wgmma, so they stay
// well under the tensor cores' rate; their times stand beside the bound in
// PERF.md.
//
// Plain C interface for ctypes; the entry points return cudaGetLastError().

#include "mma_utils.cuh"

using namespace hv;

namespace {

constexpr int NT = 256;                 // threads of a block: 8 warps
constexpr int TW = 16;                  // output columns of a block
constexpr int AW = TW + 2;              // staged input columns
constexpr int KC = 32;                  // input channels per chunk
constexpr int AS = KC + 8;              // staged pixel stride: ldmatrix rows on distinct banks
constexpr int NFRAG = 4;
constexpr int NCOL = 16 * NFRAG;        // output channels of a block
constexpr int LDB = NCOL + 8;           // staged weight row stride
constexpr int BANDS_PER_BLOCK = 8;      // successive bands one block walks

struct Params {
  const bf* x;        // padded input (B, H + 2, WP, CINP)
  const bf* wk;       // (9, CINP, NP), zeros past Cin and COUT
  bf* out;            // (B, H, W, COUT)
  size_t img_stride;  // elements from one image of x to the next
  size_t band_stride; // elements from one band of x to the next
  int H, W, WP, CINP, COUT, NP, NBANDS;
};

// elements of one slot: the input piece and one chunk of weights
__host__ __device__ constexpr int slot_elems(int th) { return (th + 2) * AW * AS + 9 * KC * LDB; }

// One step's operands into a slot: channels [q * KC, (q + 1) * KC) of the
// band's (TH + 2) x AW pixels from column x0, and of the nine taps' weights
// for output channels [n0, n0 + NCOL).
template <int TH>
__device__ __forceinline__ void stage_step(bf* slot, const Params& p, const bf* band, int x0,
                                           int q, int n0, int tid) {
  bf* A = slot;
  bf* Bs = slot + (TH + 2) * AW * AS;
  constexpr int N8 = KC / 8;
  for (int i = tid; i < (TH + 2) * AW * N8; i += NT) {
    const int s = i % N8, pix = i / N8;
    const int r = pix / AW, c = pix % AW;
    if (x0 + c < p.WP)
      cp_async16(A + pix * AS + s * 8,
                 band + ((size_t)r * p.WP + x0 + c) * p.CINP + q * KC + s * 8);
  }
  constexpr int SEGS = NCOL / 8;
  for (int i = tid; i < 9 * KC * SEGS; i += NT) {
    const int s = i % SEGS, row = i / SEGS;       // row = tap * KC + k
    const int tap = row / KC, k = row % KC;
    cp_async16(Bs + row * LDB + s * 8,
               p.wk + (size_t)(tap * p.CINP + q * KC + k) * p.NP + n0 + s * 8);
  }
}

// One tap of one chunk for the R rows of a warp. a: the lane's address in the
// tap's window of the first row; b: the lane's address in the tap's weights.
template <int R>
__device__ __forceinline__ void tap_product(float (&acc)[R][2 * NFRAG][4], const bf* a,
                                            const bf* b) {
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    unsigned fa[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) ldsm_x4(fa[r], a + r * AW * AS + kk);
#pragma unroll
    for (int f = 0; f < NFRAG; ++f) {
      unsigned fb[4];
      ldsm_x4_t(fb, b + kk * LDB + f * 16);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        mma_bf16(acc[r][2 * f], fa[r], fb[0], fb[1]);
        mma_bf16(acc[r][2 * f + 1], fa[r], fb[2], fb[3]);
      }
    }
  }
}

// The nine taps of a staged chunk, ky-major. acc[r][j][.]: band row R * warp
// + r, output channels 8 * j .. 8 * j + 7, in the m16n8 accumulator layout
// (lane = 4 g + t: [0], [1] at pixel g, channels 2t, 2t + 1; [2], [3] at
// pixel g + 8). UNROLLED: nine fixed windows; otherwise a loop over the tap
// index with computed offsets.
template <int R, bool UNROLLED>
__device__ __forceinline__ void mma_taps(float (&acc)[R][2 * NFRAG][4], const bf* A,
                                         const bf* Bs, int warp, int lane) {
  // A: 16 pixels of a row (one per lane % 16), k-half by lane / 16
  const bf* a_lane = A + (warp * R * AW + (lane & 15)) * AS + (lane >> 4) * 8;
  // B: rows k of a tap (one per lane % 16), channel half by lane / 16
  const bf* b_lane = Bs + (lane & 15) * LDB + (lane >> 4) * 8;
  if (UNROLLED) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        tap_product<R>(acc, a_lane + (ky * AW + kx) * AS, b_lane + (3 * ky + kx) * KC * LDB);
  } else {
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap - 3 * ky;
      tap_product<R>(acc, a_lane + (ky * AW + kx) * AS, b_lane + tap * KC * LDB);
    }
  }
}

// Round the band's accumulators once and store them, masked past W and COUT;
// leaves the accumulators zero for the next band.
template <int R>
__device__ __forceinline__ void store_band(float (&acc)[R][2 * NFRAG][4], const Params& p,
                                           int b, int y0, int x0, int n0, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (p.COUT & 1) == 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gy = y0 + warp * R + r;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + g + 8 * half;
      bf* o = p.out + ((size_t)(b * p.H + gy) * p.W + gx) * p.COUT;
#pragma unroll
      for (int j = 0; j < 2 * NFRAG; ++j) {
        const int co = n0 + j * 8 + 2 * t;
        const float v0 = acc[r][j][2 * half], v1 = acc[r][j][2 * half + 1];
        acc[r][j][2 * half] = 0.f;
        acc[r][j][2 * half + 1] = 0.f;
        if (gx >= p.W) continue;
        if (pairs && co + 1 < p.COUT) {
          *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < p.COUT) o[co] = from_f<bf>(v0);
          if (co + 1 < p.COUT) o[co + 1] = from_f<bf>(v1);
        }
      }
    }
  }
}

// This block: image blockIdx.z, bands [BANDS_PER_BLOCK * blockIdx.y, ...),
// column segment and channel tile from blockIdx.x (channel tile fastest, so
// blocks that share an input piece are neighbours and find it in L2).
template <int R, bool UNROLLED>
__device__ __forceinline__ void band_conv(const Params& p, bf* slots) {
  constexpr int TH = 8 * R;
  constexpr int SLOT = slot_elems(TH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nct = p.NP / NCOL;
  const int n0 = (blockIdx.x % nct) * NCOL, x0 = (blockIdx.x / nct) * TW;
  const int i0 = blockIdx.y * BANDS_PER_BLOCK, b = blockIdx.z;
  const int nb = min(BANDS_PER_BLOCK, p.NBANDS - i0);
  const int nchunks = p.CINP / KC;
  const int steps = nb * nchunks;
  const bf* img = p.x + (size_t)b * p.img_stride;
  float acc[R][2 * NFRAG][4] = {};

  stage_step<TH>(slots, p, img + (size_t)i0 * p.band_stride, x0, 0, n0, tid);
  cp_async_commit();
  int band = i0, q = 0;                  // of step s
  for (int s = 0; s < steps; ++s) {
    int band_n = band, q_n = q + 1;      // of step s + 1
    if (q_n == nchunks) { q_n = 0; ++band_n; }
    if (s + 1 < steps) {
      // the other slot was read in step s - 1; the barrier that ended that
      // step lets this copy overwrite it
      stage_step<TH>(slots + ((s + 1) & 1) * SLOT, p,
                           img + (size_t)band_n * p.band_stride, x0, q_n, n0, tid);
      cp_async_commit();
      cp_async_wait<1>();                // step s has landed; s + 1 is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf* A = slots + (s & 1) * SLOT;
    mma_taps<R, UNROLLED>(acc, A, A + (TH + 2) * AW * AS, warp, lane);
    if (q == nchunks - 1) store_band<R>(acc, p, b, band * TH, x0, n0, warp, lane);
    __syncthreads();
    band = band_n;
    q = q_n;
  }
}

template <int R>
__global__ void __launch_bounds__(NT) conv_band_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  band_conv<R, true>(p, reinterpret_cast<bf*>(smem_raw));
}

template <int R>
__global__ void __launch_bounds__(NT) conv_dma_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  band_conv<R, false>(p, reinterpret_cast<bf*>(smem_raw));
}

template <typename K>
cudaError_t launch(K kernel, const Params& p, dim3 grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int W, int WP, int CINP, int COUT, int NP, int TH) {
  return B <= 0 || H <= 0 || W <= 0 || (TH != 8 && TH != 16 && TH != 32) || H % TH ||
         WP < W + 2 || WP % 8 || CINP <= 0 || CINP % KC || COUT <= 0 || NP % NCOL ||
         NP < COUT;
}

enum Kind { BAND, DMA };

int forward(Kind kind, const void* x, const void* wk, void* out, int B, int H, int W, int WP,
            int CINP, int COUT, int NP, int TH, void* stream) {
  if (bad_shape(B, H, W, WP, CINP, COUT, NP, TH)) return (int)cudaErrorInvalidValue;
  const int nbands = H / TH;
  const size_t row = (size_t)WP * CINP;
  Params p{static_cast<const bf*>(x), static_cast<const bf*>(wk), static_cast<bf*>(out),
           (size_t)(H + 2) * row, (size_t)TH * row,
           H, W, WP, CINP, COUT, NP, nbands};
  const int gx = (W + TW - 1) / TW * (NP / NCOL);
  const int gy = (nbands + BANDS_PER_BLOCK - 1) / BANDS_PER_BLOCK;
  const dim3 grid(gx, gy, B);
  const size_t smem = (size_t)slot_elems(TH) * sizeof(bf) * 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HV_LAUNCH(KERNEL)                                                  \
  (TH == 8 ? launch(KERNEL<1>, p, grid, smem, s)                           \
           : TH == 16 ? launch(KERNEL<2>, p, grid, smem, s) : launch(KERNEL<4>, p, grid, smem, s))
  if (kind == BAND) return (int)HV_LAUNCH(conv_band_kernel);
  return (int)HV_LAUNCH(conv_dma_kernel);
#undef HV_LAUNCH
}

}  // namespace

extern "C" {

// xp: (B, H + 2, WP, CINP) bf16, the input with one zero row above and below,
// one zero column left, WP - W - 1 right (WP = W + 2 rounded up to 8) and
// channels zero-padded to CINP % 32 == 0. wk: (9, CINP, NP) bf16, NP = COUT
// padded to 64. out: (B, H, W, COUT) bf16. TH: 8, 16 or 32, H % TH == 0.
int conv_band_forward_bf16(const void* xp, const void* wk, void* out, int B, int H, int W,
                           int WP, int CINP, int COUT, int NP, int TH, void* stream) {
  return forward(BAND, xp, wk, out, B, H, W, WP, CINP, COUT, NP, TH, stream);
}

int conv_dma_forward_bf16(const void* xp, const void* wk, void* out, int B, int H, int W,
                          int WP, int CINP, int COUT, int NP, int TH, void* stream) {
  return forward(DMA, xp, wk, out, B, H, W, WP, CINP, COUT, NP, TH, stream);
}

}  // extern "C"
