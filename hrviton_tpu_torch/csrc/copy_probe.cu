// The band-copy probe for Hopper (sm_90a): a passthrough of x through the
// halo-band copy, to time the copy mechanism by itself.
//
// band_copy_probe_kernel replaces the TPU kernel tools/exp_dma_probe.py:_kernel
// (reached through probe, whose pl.pallas_call is at exp_dma_probe.py:67).
// Band i of an unpadded image is its rows [i * TH - 1, i * TH + TH + 1)
// clipped to the image, copied into a slot of TH + 2 rows; slot rows 1 .. TH
// are written out. The TPU kernel holds a whole-width band in fast memory,
// double-buffered, and starts band i + 1's copy in grid step i of a grid that
// runs in order; its copies have three cases (first band, middle, last).
//
// Here the data path is device memory -> shared memory -> device memory with
// no register in it, as the port's conv kernels get their tiles. A slot is
// one TMA box of the 4-D map over x (channels innermost, no swizzle): TH + 2
// rows x SW columns x CB channels at row i * TH - 1; the rows and columns
// outside the image arrive as zeros and are never written out, so the three
// band cases are one. Its TH interior rows go back by one TMA store through a
// map of `out` (what lies outside the image is not written). One thread of a
// block issues everything over a ring of up to MAX_SLOTS slots on one
// mbarrier each: a slot is loaded again only after cp.async.bulk.wait_group
// .read says that its store has read it, so the loads of the next slots are
// in flight while a store drains. A block walks a run of the (image, column
// segment, channel box, band) items with the band fastest, so the halo rows
// that a band reads again were read by the band before and are found in L2.
// The grid is one block an SM.
//
// What bounds it on this card: bytes, x read once and out written once (the
// halo rows, 2 / TH of x more, are read again from L2).
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError(),
// cudaErrorInvalidValue for a shape it does not take, or 1000 + the CUresult
// if a tensor map cannot be encoded.

#include <algorithm>

#include "tma_wgmma.cuh"

using namespace hv;

namespace {

constexpr int MAX_SLOTS = 6;
// a slot's bytes, unless one unit of columns is more; the ring's, less the
// alignment slack and the barriers
constexpr unsigned SLOT_TARGET = 48 * 1024;
constexpr unsigned RING_LIMIT = 232448 - 256;

struct ProbeParams {
  int TH, NBANDS, NSEG, NCB, SW, CB;   // band height; bands, column segments and
                                       // channel boxes of an image; a box's columns
                                       // and channels
  int ITEMS, SLOTS;                    // B NSEG NCB NBANDS items; slots of the ring
  unsigned SLOT_BYTES, ROW_BYTES;      // a slot, one of its rows
};

__global__ void __launch_bounds__(32, 1)
    band_copy_probe_kernel(const __grid_constant__ CUtensorMap tmx,
                           const __grid_constant__ CUtensorMap tmo, const ProbeParams p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bars[MAX_SLOTS];
  if (threadIdx.x != 0) return;
  // a tensor copy's shared-memory end is 128-byte aligned: so is the ring,
  // and a slot and its rows are whole 128-byte lines (SW CB 2 % 128 == 0)
  const unsigned ring = (smem_u32(smem_raw) + 127u) & ~127u, bar0 = smem_u32(bars);
  for (int s = 0; s < p.SLOTS; ++s) mbar_init(bar0 + 8 * s, 1);
  mbar_fence_init();
  fence_proxy_async();
  const int j0 = (int)((long long)blockIdx.x * p.ITEMS / gridDim.x);
  const int j1 = (int)((long long)(blockIdx.x + 1) * p.ITEMS / gridDim.x);
  // item j: band fastest, then channel box, column segment, image
  auto coords = [&](int j, int& c, int& x, int& y, int& b) {
    y = (j % p.NBANDS) * p.TH;
    j /= p.NBANDS;
    c = (j % p.NCB) * p.CB;
    j /= p.NCB;
    x = (j % p.NSEG) * p.SW;
    b = j / p.NSEG;
  };
  auto load = [&](int j) {
    int c, x, y, b;
    coords(j, c, x, y, b);
    const int slot = (j - j0) % p.SLOTS;
    const unsigned bar = bar0 + 8 * slot;
    mbar_expect_tx(bar, p.SLOT_BYTES);   // rows outside the image count too
    tma_load_4d(ring + slot * p.SLOT_BYTES, &tmx, bar, c, x, y - 1, b);
  };
  for (int j = j0; j < min(j1, j0 + p.SLOTS); ++j) load(j);
  for (int j = j0; j < j1; ++j) {
    const int k = j - j0, slot = k % p.SLOTS;
    mbar_wait(bar0 + 8 * slot, (k / p.SLOTS) & 1);
    fence_proxy_async();
    int c, x, y, b;
    coords(j, c, x, y, b);
    tma_store_4d(&tmo, ring + slot * p.SLOT_BYTES + p.ROW_BYTES, c, x, y, b);
    bulk_commit();
    // the previous item's store has read its slot: refill it
    if (k > 0 && j - 1 + p.SLOTS < j1) {
      bulk_wait_read<1>();
      load(j - 1 + p.SLOTS);
    }
  }
  bulk_wait<0>();
}

// x or out (B, H, W, C) bf16 as a 4-D map, innermost first: a box of cb
// channels x sw columns x rows, no swizzle, zero-filled outside the tensor.
CUresult encode_pixels(CUtensorMap* map, const void* t, int B, int H, int W, int C, int cb,
                       int sw, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cb, (cuuint32_t)sw, (cuuint32_t)rows, 1};
  return encode(map, t, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

}  // namespace

extern "C" {

// x, out: (B, H, W, C) bf16, contiguous and 16-byte aligned; C % 8 == 0 (the
// map's strides are multiples of 16 bytes); H % TH == 0, TH + 2 <= 256 (a
// box's rows).
int band_copy_probe_bf16(const void* x, void* out, int B, int H, int W, int C, int TH,
                         void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || TH <= 0 || H % TH || TH + 2 > 256)
    return (int)cudaErrorInvalidValue;
  // channel boxes of at most 256 (a box's extent), a multiple of 8 each
  const int ncb = (C + 255) / 256, cb = ((C + ncb - 1) / ncb + 7) / 8 * 8;
  // columns of a box: a multiple of `unit`, so that a row is whole 128-byte
  // lines; as many as SLOT_TARGET holds, up to the image's width and 256
  int unit = 8;
  while (unit > 1 && (unit / 2) * cb * 2 % 128 == 0) unit /= 2;
  const unsigned col_bytes = (unsigned)(TH + 2) * cb * 2;
  const int wmax = (W + unit - 1) / unit * unit;
  int sw = unit;
  while (sw + unit <= 256 && sw + unit <= wmax && (sw + unit) * col_bytes <= SLOT_TARGET)
    sw += unit;
  const unsigned slot_bytes = sw * col_bytes;
  const int slots = (int)std::min<unsigned>(MAX_SLOTS, RING_LIMIT / slot_bytes);
  if (slots < 2) return (int)cudaErrorInvalidValue;
  CUtensorMap tmx, tmo;
  CUresult res = encode_pixels(&tmx, x, B, H, W, C, cb, sw, TH + 2);
  if (res == CUDA_SUCCESS) res = encode_pixels(&tmo, out, B, H, W, C, cb, sw, TH);
  if (res != CUDA_SUCCESS) return 1000 + (int)res;
  const size_t smem = (size_t)slots * slot_bytes + 128;
  cudaError_t err = cudaFuncSetAttribute(
      band_copy_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nbands = H / TH, nseg = (W + sw - 1) / sw;
  const long long items = (long long)B * nseg * ncb * nbands;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const ProbeParams p{TH, nbands, nseg, ncb, sw, cb, (int)items, slots, slot_bytes,
                      (unsigned)sw * cb * 2};
  const int grid = (int)std::min<long long>(sm_count(), items);
  band_copy_probe_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(tmx, tmo, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
