// Helpers for kernels built from Hopper's asynchronous units (sm_90a):
// mbarriers, TMA tensor loads and stores (cp.async.bulk.tensor through a
// CUtensorMap passed as a __grid_constant__ kernel parameter; a store's
// completion tracked by bulk groups) and plain bulk copies,
// thread-block clusters (a block's rank, the cluster barrier, an arrival on a
// peer's mbarrier, a tensor load multicast to every block), the warpgroup
// matrix product (wgmma.mma_async) with both operands in shared
// memory, the transposing store of accumulator fragments (stmatrix), and on
// the host the card's SM count and the encoding of a tensor map.
//
// The operand layout used throughout is "K-major with the 32-byte swizzle": a
// matrix row (an M or N index) holds 16 bf16 values of K in 32 contiguous
// bytes, eight successive rows are 256 contiguous bytes (one swizzle pattern:
// the hardware XORs address bit 4 with address bit 7), and groups of eight
// rows lie `sbo` bytes apart. A TMA box whose innermost extent is 16 bf16
// values, loaded with CU_TENSOR_MAP_SWIZZLE_32B to a 256-byte aligned
// address, has exactly that layout, with the pixels (or output channels) of
// the box as the rows.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hv {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// after the inits of one thread, before any other thread or the copy engine
// uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival, and `bytes` more for the copy engine to count down
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of this parity is complete. A phase that
// never completes (a byte count that does not match, a lost arrival) is a
// fault after about a second, not a hang.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 31)) __trap();
  }
}

// ---- TMA ---------------------------------------------------------------

// orders generic-proxy writes to shared memory before the asynchronous
// proxy's (TMA, wgmma) accesses
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// One box of a 4-D tensor map into shared memory at `dst`; coordinates
// innermost first, signed: what lies outside the tensor arrives as the map's
// fill value and still counts towards the barrier's bytes.
__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 4-D tensor map from shared memory at `src` (128-byte aligned,
// laid out as the load of the same box lays it) to the tensor, as a bulk
// group of this thread (cp.async.bulk.tensor shared -> global): what lies
// outside the tensor is not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, unsigned src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// closes this thread's bulk group of the stores issued since the last one
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's bulk groups still read shared memory
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// waits until at most N of this thread's bulk groups are not yet complete
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned) into
// shared memory at `dst`, counted on the barrier like a tensor box
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// a barrier among `count` threads (a multiple of 32) under name `id` (not 0,
// which __syncthreads uses)
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrive on named barrier `id` without waiting: the writes before it are
// visible to the threads that wait there (bar.sync) once it completes.
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- thread-block clusters -------------------------------------------------

// this block's rank in its cluster (%cluster_ctarank)
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster arrives and waits
// (barrier.cluster.arrive / barrier.cluster.wait, release / acquire); not
// .aligned, so a warp may reach it diverged.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}
// One arrival on the barrier at the same shared-memory offset in the block of
// rank `rank` (mapa.shared::cluster, then mbarrier.arrive.shared::cluster with
// the default .release.cta). What it releases are reads of shared memory by
// wgmma that wgmma.wait_group has seen complete, so no wider fence is needed:
// .release.cluster costs a MEMBAR.ALL.GPU per arrival, which waits for every
// global store of the thread in flight (measured, PERF.md §6).
__device__ __forceinline__ void mbar_arrive_cluster(unsigned bar, unsigned rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar), "r"(rank)
      : "memory");
}
// One box of a 3-D tensor map into the shared memory of every block of the
// cluster in `mask`, at the same offset `dst` in each, each block's barrier at
// offset `bar` counting the box's bytes
// (cp.async.bulk.tensor...multicast::cluster).
__device__ __forceinline__ void tma_load_3d_multicast(unsigned dst, const CUtensorMap* map,
                                                      unsigned bar, int c0, int c1, int c2,
                                                      unsigned short mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1),
        "r"(c2)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------

constexpr unsigned WGMMA_SWIZZLE_32B = 3;   // the descriptor's layout code

// The shared-memory descriptor of a K-major swizzled operand: the address of
// row 0 at this instruction's 16 values of K, the byte distance `sbo` between
// groups of eight rows, the layout code. The leading byte offset is not used
// by swizzled K-major layouts (set to 1, as the ISA asks). The address may lie
// inside a swizzle pattern (a window that starts some rows into a group): the
// hardware swizzles on the bits of the absolute shared-memory address, as the
// copy engine did when it wrote the tile, so the descriptor's base_offset
// field stays 0 (measured on the H100: a window one or two 32-byte rows into
// a pattern multiplies right with the field 0, and also with (addr >> 7) & 7).
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned sbo, unsigned layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N> __device__ __forceinline__ void wgmma_fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, this warpgroup's accumulator) = a (64 x 16 bf16) x b (128 x
// 16 bf16, K-major) + (scale_d ? d : 0), both operands in shared memory.
// Thread 32 w + 4 g + t of the warpgroup holds rows 16 w + g (d[4 j], d[4 j +
// 1]) and 16 w + g + 8 (d[4 j + 2], d[4 j + 3]) at columns 8 j + 2 t, + 1.
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t desc_a,
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Four 8 x 8 b16 matrices of a warp's accumulator fragments (lane 4 g + t
// holds row g, columns 2 t, 2 t + 1 of matrix k in r_k), each transposed into
// shared memory: row r of matrix k (the fragments' column r) as 16 bytes at
// the address that lane 8 k + r gives.
__device__ __forceinline__ void stmatrix_x4_trans(unsigned addr, unsigned r0, unsigned r1,
                                                  unsigned r2, unsigned r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}
__device__ __forceinline__ void st_shared_u16(unsigned addr, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}
__device__ __forceinline__ uint4 ld_shared_v4(unsigned addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}

// ---- host ------------------------------------------------------------------

// the card's streaming multiprocessors (132 if the runtime cannot say)
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

// tensor maps

typedef CUresult (*EncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; it is fetched through the runtime,
// so a library links no libcuda.
inline EncodeFn encode_fn() {
  static EncodeFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) f = nullptr;
    return reinterpret_cast<EncodeFn>(f);
  }();
  return fn;
}

// a bf16 tensor map; outside the tensor a box is zero-filled
inline CUresult encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle, CUtensorMapL2promotion l2) {
  EncodeFn fn = encode_fn();
  if (!fn) return CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(ptr), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, l2,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// x as it is, (B, H, W, C) bf16: dimensions innermost first, a box of 16
// channels (one 32-byte swizzle row) x sc columns x rows; outside the tensor
// the box is zero-filled (the conv's zero border, and channels past C).
inline CUresult encode_x(CUtensorMap* map, const void* x, int B, int H, int W, int C, int sc,
                         int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {16, (cuuint32_t)sc, (cuuint32_t)rows, 1};
  return encode(map, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

// x (B, H, W, C) bf16 with C so small that a pixel is no 16-byte row, as
// rows of W * C elements: a box of `elems` elements (a multiple of 8, at most
// 256) x rows x 1 image, no swizzle; it may start at any element, and outside
// a row (the zero border left and right) or the image it is zero-filled.
// Needs W * C % 8 == 0 (a row's stride a multiple of 16 bytes).
inline CUresult encode_rows(CUtensorMap* map, const void* x, int B, int H, int W, int C,
                            int elems, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)W * C, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * C * 2, (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[3] = {(cuuint32_t)elems, (cuuint32_t)rows, 1};
  return encode(map, x, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

}  // namespace hv
