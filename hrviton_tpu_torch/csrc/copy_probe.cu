// The band-copy probe for Hopper (sm_90a): a passthrough of x through a
// double-buffered halo-band copy, to time the copy mechanism by itself.
//
// band_copy_probe_kernel replaces the TPU kernel tools/exp_dma_probe.py:_kernel
// (reached through probe, whose pl.pallas_call is at exp_dma_probe.py:67).
// Band i of an unpadded image is its rows [i * TH - 1, i * TH + TH + 1)
// clipped to the image: the first band has TH + 1 rows and lands in slot rows
// 1 .., a middle band has TH + 2, the last has TH + 1 and lands in slot rows
// 0 ... Slot rows 1 .. TH are written out; slot row 0 of the first band and
// row TH + 1 of the last are never filled and never read.
//
// The TPU kernel holds a whole-width band in fast memory and starts band
// i + 1's copy in grid step i of a grid that runs in order. Here blocks run
// in no order and a block has at most 227 KB, so a block owns a column
// segment of SW pixels (in NHWC one contiguous span per row) and walks up to
// BANDS_PER_BLOCK successive bands of one image itself, with two slots in
// shared memory. The copy into a slot is the asynchronous bulk copy
// (cp.async.bulk, one per row, started by one thread) that reports its bytes
// to an mbarrier; the barrier's expected byte count is set per band from the
// rows that band really has, since the three cases differ. All threads wait
// on the barrier's phase and write the interior rows out with 16-byte stores
// while the next band's copy is in flight.
//
// What bounds it on this card: bytes, every byte read once and written once
// (plus 2 / TH of re-read halo rows). Two slots of at most 56 KB leave room
// for two blocks on an SM.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int BANDS_PER_BLOCK = 8;
constexpr size_t SLOT_BUDGET = 56 * 1024;
constexpr size_t SMEM_MAX = 226 * 1024;   // 227 KB less the barriers

struct ProbeParams {
  const unsigned char* x;   // (B, H, W, C), PIX bytes a pixel
  unsigned char* out;       // the same
  int H, W, TH, NBANDS, SW, PIX;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait until the barrier has left the phase of this parity; a copy that never
// completes (a byte count that does not match) is a fault, not a hang
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// bytes (a multiple of 16) from device memory to shared memory, both 16-byte
// aligned; completion is counted on the barrier
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__global__ void __launch_bounds__(NT) band_copy_probe_kernel(const ProbeParams p) {
  extern __shared__ __align__(128) unsigned char slots[];
  __shared__ __align__(8) unsigned long long bars[2];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * p.SW, b = blockIdx.z;
  const int i0 = blockIdx.y * BANDS_PER_BLOCK;
  const int i1 = min(i0 + BANDS_PER_BLOCK, p.NBANDS);
  const unsigned span = (unsigned)min(p.SW, p.W - x0) * p.PIX;   // bytes of a row piece
  const unsigned srow = (unsigned)p.SW * p.PIX;                  // slot row stride
  const unsigned slot_bytes = (p.TH + 2) * srow;
  const size_t grow = (size_t)p.W * p.PIX;                       // image row stride
  const size_t origin = ((size_t)b * p.H * p.W + x0) * p.PIX;    // row 0 of the segment
  const unsigned char* src = p.x + origin;
  unsigned char* dst = p.out + origin;
  const unsigned slot0 = smem_addr(slots);
  const unsigned bar0 = smem_addr(&bars[0]), bar1 = smem_addr(&bars[1]);

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: start band i's copy into a slot
  auto fetch = [&](int slot, int i) {
    const int first = i == 0, last = i == p.NBANDS - 1;
    const int nrows = p.TH + 2 - first - last;
    const int r0 = first ? 0 : i * p.TH - 1;
    const unsigned bar = slot ? bar1 : bar0;
    const unsigned to = slot0 + slot * slot_bytes + first * srow;
    mbar_expect_tx(bar, nrows * span);
    for (int r = 0; r < nrows; ++r)
      bulk_copy(to + r * srow, src + (size_t)(r0 + r) * grow, span, bar);
  };

  if (tid == 0) fetch(0, i0);
  const int vecs = span / 16;
  for (int i = i0; i < i1; ++i) {
    const int k = i - i0, slot = k & 1;
    // the other slot was read in the previous iteration, which ended on a
    // barrier of the block
    if (tid == 0 && i + 1 < i1) fetch(slot ^ 1, i + 1);
    mbar_wait(slot ? bar1 : bar0, (k >> 1) & 1);
    const unsigned char* rows = slots + (size_t)slot * slot_bytes + srow;   // slot row 1
    unsigned char* o = dst + (size_t)i * p.TH * grow;
    for (int idx = tid; idx < p.TH * vecs; idx += NT) {
      const int r = idx / vecs, v = idx - r * vecs;
      *reinterpret_cast<uint4*>(o + (size_t)r * grow + v * 16) =
          *reinterpret_cast<const uint4*>(rows + (size_t)r * srow + v * 16);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// x, out: (B, H, W, C) bf16, contiguous and 16-byte aligned; C % 8 == 0 (a
// pixel is a multiple of 16 bytes); H % TH == 0.
int band_copy_probe_bf16(const void* x, void* out, int B, int H, int W, int C, int TH,
                         void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || TH <= 0 || H % TH)
    return (int)cudaErrorInvalidValue;
  const int pix = C * 2;
  int sw = 64;
  while (sw > 1 && (size_t)(TH + 2) * sw * pix > SLOT_BUDGET) sw >>= 1;
  if (sw > W) sw = W;
  const size_t smem = (size_t)2 * (TH + 2) * sw * pix;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      band_copy_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nbands = H / TH;
  ProbeParams p{static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
                H, W, TH, nbands, sw, pix};
  const dim3 grid((W + sw - 1) / sw, (nbands + BANDS_PER_BLOCK - 1) / BANDS_PER_BLOCK, B);
  band_copy_probe_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
