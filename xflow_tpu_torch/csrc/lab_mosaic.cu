// Slice-shape probes of the Hopper lab (sm_90a): kernels #7-#10, the
// counterparts of `suite_mosaic`'s four Pallas DMA probes
// (xflow_tpu/tools/bench_lab.py: `fa` :441 with body `kern_a` :438, `fb`
// :462 / `kern_b` :454, `fc` :484 / `kern_c` :476, `fd` :506 / `kern_d`
// :498). On the TPU the probe asked which slices Mosaic can DMA; here it
// asks which slices of the port's tables the Tensor Memory Accelerator
// (TMA) can copy into shared memory, and each kernel runs and is checked.
//
// Bound on the H100: not by bytes. Each probe moves at most 1.44 MB (the
// bytes bound is under 1 us) over 4 to 256 blocks; a block's barrier
// set-up, one copy's round trip to device memory and the store run one
// after another. `tools/bench_lab.py` reads each probe's device time with
// torch.profiler: CUDA events around back-to-back calls read the host's
// dispatch of the launch instead.
//
//   #7 (A) out = scale * table over [W, K] row blocks: a 1-D bulk copy
//      (`cp.async.bulk`) of a 16 B aligned piece of a block's W*K*4 B
//      window into shared memory, scaled, stored back with 16 B stores.
//      One CTA a window would leave 32 CTAs on 132 SMs at the probe's
//      shapes (S 2^14, W 512, K 11: 22,528 B windows), each running its
//      chain alone; the launch splits every window into the most pieces
//      (a power of two) that keep the grid within two CTAs a SM, 8
//      pieces of 2,816 B and 256 CTAs there, and thread 0 issues its
//      copy before the barrier that publishes the mbarrier to the other
//      threads. A 2-D tensor map cannot describe the table: its row
//      stride, 44 B, is not a multiple of 16.
//   #8 (B), #9 (C) a [R, C] column slice of a [R, N] array at the column
//      (off[t] / C) * C. One CTA a slice would leave 4 CTAs on 132 SMs,
//      each running the whole slice's chain alone, so the slice is cut into
//      P column pieces (P a power of two, from `ops/lab.py::col_pieces`:
//      the most that keep the grid within one CTA a SM, each piece's width
//      a multiple of 16 B and at most 256 elements), a one-warp CTA a
//      piece: one 2-D TMA box [R, C/P] in through a tensor map over [R, N]
//      (row stride N*4 B), one TMA store out through a second map over the
//      tiles as [grid*R, C] with the same box (on the H100 it measured
//      faster than the warp's 16 B stores). One source serves f32 (B, R 11)
//      and i32 (C, R 1): the copy moves 4 B words, so the tiles are bitwise
//      the slices.
//   #10 (D) a [C, K] row slice of an [N, K] f32 array at the unaligned row
//      off[t], cut into P pieces of C/P rows (`row_pieces`: C/P a multiple
//      of 4, so every piece's output starts on 16 B). A piece makes one
//      1-D bulk copy of the 16 B aligned span enclosing its bytes; the
//      shift (0, 4, 8 or 12 B) is made in registers for the warp's 16 B
//      stores (on the H100 they measured faster than a shift into a
//      staging area and one bulk store). No tensor map can describe a
//      44 B row stride.
//
// A TPU grid runs in order, so its kernels write one scalar at every grid
// step and the last step's value stays. The blocks here run in any order:
// each writes its own scalar (`scalars[t]`, the TPU's value is the last),
// and its own tile, so the check sees every copy. A block whose slice
// leaves the array writes zeros (tile and scalar) and copies nothing.
//
// A transaction that never completes (a wrong byte count) would hang the
// block on its barrier: the wait traps after about a second instead.
// `xf_lab_tma_encode` reports what cuTensorMapEncodeTiled says of any 2-D
// map: the probe's counterpart of the TPU's OK/FAIL lines.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long WAIT_CYCLES = 2000000000LL;  // about 1 s at the H100's clock
constexpr int THREADS = 256;                  // #7's CTA
constexpr int WARP = 32;                      // #8-#10's CTA: one warp a piece
constexpr int SMEM_SLACK = 128;               // room to align the tile to 128 B

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 128 B aligned byte of the dynamic shared memory (tensor-map
// destinations need 128 B, bulk copies 16 B).
__device__ __forceinline__ unsigned char* aligned_tile(unsigned char* raw) {
  uint32_t a = smem_addr(raw);
  return raw + ((128u - (a & 127u)) & 127u);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase `parity` completes; trap after
// WAIT_CYCLES, so a transaction that never lands fails the launch.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_CYCLES) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Order this thread's generic-proxy writes and reads of shared memory
// before the async proxy's (a bulk store's) reads of it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Commit this thread's bulk stores and wait until they have read their
// shared memory, which must outlive them (the CTA may exit after this).
__device__ __forceinline__ void bulk_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// #7: dst[piece] = scale * src[piece], one piece of `piece_floats` floats
// per CUDA block.
__global__ void scale_blocks_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                    int piece_floats, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  float* tile = reinterpret_cast<float*>(aligned_tile(smem_raw));
  const long long base = (long long)blockIdx.x * piece_floats;
  const uint32_t bytes = (uint32_t)piece_floats * 4u;
  if (threadIdx.x == 0) {
    bar_init(&bar);
    bar_expect_tx(&bar, bytes);
    bulk_load(tile, src + base, bytes, &bar);
  }
  __syncthreads();
  bar_wait(&bar, 0);
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  float4* d4 = reinterpret_cast<float4*>(dst + base);
  for (int i = threadIdx.x; i < piece_floats / 4; i += blockDim.x) {
    float4 v = t4[i];
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
    d4[i] = v;
  }
}

// #8 / #9: CTA (p, t), one warp, copies column piece p ([rows, width] at
// column start + p * width) of the [rows, chunk] slice at start = (off[t] /
// chunk) * chunk of a [rows, cols] array of 4 B words into tiles[t]
// ([rows, chunk]); piece 0 writes the slice's first word to scalars[t].
// The offset's load is issued first; lane 0 prefetches the maps and arms the
// barrier while it is in flight, then issues the box and, once it has
// landed, one TMA store of it. `chunk_shift` is log2(chunk) where chunk is
// a power of two (no division), else -1. A slice out of range is zeroed
// by the warp's 16 B stores.
__global__ void __launch_bounds__(WARP) dma_cols_kernel(
    const __grid_constant__ CUtensorMap src_map, const __grid_constant__ CUtensorMap out_map,
    const int32_t* __restrict__ off, uint32_t* __restrict__ tiles,
    uint32_t* __restrict__ scalars, int rows, long long cols, int chunk, int chunk_shift,
    int width, uint32_t q_magic) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  uint32_t* tile = reinterpret_cast<uint32_t*>(aligned_tile(smem_raw));
  const int p = blockIdx.x, t = blockIdx.y, lane = threadIdx.x;
  const int o = off[t];
  if (lane == 0) {
    prefetch_map(&src_map);
    prefetch_map(&out_map);
    bar_init(&bar);
    bar_expect_tx(&bar, (uint32_t)rows * width * 4u);
  }
  const long long start = o < 0 ? cols
                          : chunk_shift >= 0 ? (long long)(o >> chunk_shift) << chunk_shift
                                             : (long long)(o / chunk) * chunk;
  const int col = p * width;
  const int q = width / 4;  // 16 B words a row of the piece (width is a multiple of 4)
  uint4* out = reinterpret_cast<uint4*>(tiles + (long long)t * rows * chunk + col);
  const int out_stride = chunk / 4;
  // the piece's i-th 16 B word is (row i / q, column i % q): i / q is
  // (i * q_magic) >> 31, exact for i < 2^16 (q_magic = 2^31 / q rounded up)
  const int words = rows * q;
  if (start + chunk > cols) {  // also off[t] < 0
    for (int i = lane; i < words; i += WARP) {
      const int r = (int)(((uint64_t)i * q_magic) >> 31);
      out[r * out_stride + i - r * q] = make_uint4(0, 0, 0, 0);
    }
    if (p == 0 && lane == 0) scalars[t] = 0;
    return;
  }
  if (lane != 0) return;
  tma_load_2d(tile, &src_map, (int)start + col, 0, &bar);
  bar_wait(&bar, 0);
  fence_proxy_async();
  tma_store_2d(&out_map, tile, col, t * rows);
  if (p == 0) scalars[t] = tile[0];
  bulk_store_drain();
}

// #10: CTA (p, t), one warp, copies rows [off[t] + p * piece_rows, + piece_rows)
// of an [n_rows, row_floats] f32 array into tiles[t] at row p * piece_rows:
// one bulk copy of the piece's enclosing 16 B aligned span, then the shift.
// piece_rows is a multiple of 4, so the piece's output starts on 16 B and
// the warp writes it with 16 B stores, the shift made in registers.
__global__ void __launch_bounds__(WARP) dma_rows_kernel(
    const float* __restrict__ src, const int32_t* __restrict__ off, float* __restrict__ tiles,
    float* __restrict__ scalars, long long n_rows, int row_floats, int chunk, int piece_rows) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  unsigned char* span = aligned_tile(smem_raw);
  const int p = blockIdx.x, t = blockIdx.y, lane = threadIdx.x;
  const long long start = off[t];
  if (lane == 0) bar_init(&bar);  // while the offset's load is in flight
  const int piece_floats = piece_rows * row_floats;
  const int q = piece_floats / 4;  // 16 B words of the piece's output
  float4* out = reinterpret_cast<float4*>(
      tiles + ((long long)t * chunk + (long long)p * piece_rows) * row_floats);
  if (start < 0 || start + chunk > n_rows) {
    for (int i = lane; i < q; i += WARP) out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p == 0 && lane == 0) scalars[t] = 0.f;
    return;
  }
  const long long b0 = (start + (long long)p * piece_rows) * row_floats * 4;
  const long long lo = b0 & ~15LL, hi = (b0 + (long long)piece_floats * 4 + 15) & ~15LL;
  const int shift = (int)(b0 - lo) / 4;  // 0..3 words
  if (lane == 0) {
    bar_expect_tx(&bar, (uint32_t)(hi - lo));
    bulk_load(span, reinterpret_cast<const unsigned char*>(src) + lo, (uint32_t)(hi - lo), &bar);
  }
  const float* words = reinterpret_cast<const float*>(span) + shift;
  __syncwarp();  // publishes the barrier's init to the other lanes
  bar_wait(&bar, 0);
  if (p == 0 && lane == 0) scalars[t] = words[0];
  for (int i = lane; i < q; i += WARP)
    out[i] = make_float4(words[4 * i], words[4 * i + 1], words[4 * i + 2], words[4 * i + 3]);
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda);
// null if the driver does not have it.
PFN_cuTensorMapEncodeTiled encode_tiled() {
  static PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

constexpr int NO_ENCODER = 1000;  // the driver has no cuTensorMapEncodeTiled (no CUresult is 1000)

// A plain 2-D tensor map (no swizzle, no interleave, zero fill) of a
// [dim1, dim0] array of 4 B elements (dim0 innermost) with a row stride of
// `stride1` bytes, in boxes of [box1, box0]. Returns the CUresult, or
// NO_ENCODER.
int encode_2d(CUtensorMap* map, const void* ptr, int is_int, long long dim0, long long dim1,
              long long stride1, int box0, int box1) {
  PFN_cuTensorMapEncodeTiled fn = encode_tiled();
  if (fn == nullptr) return NO_ENCODER;
  cuuint64_t dims[2] = {(cuuint64_t)dim0, (cuuint64_t)dim1};
  cuuint64_t strides[1] = {(cuuint64_t)stride1};
  cuuint32_t box[2] = {(cuuint32_t)box0, (cuuint32_t)box1};
  cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, is_int ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                  const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return (int)r;
}

// Opt a kernel in to `smem` bytes of dynamic shared memory where that is
// over the 48 KB every kernel gets.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int xf_lab_tma_encode(const void* ptr, int is_int, long long dim0, long long dim1,
                                 long long stride1, int box0, int box1) {
  CUtensorMap map;
  return encode_2d(&map, ptr, is_int, dim0, dim1, stride1, box0, box1);
}

// #7. `block_floats` * 4 must be a multiple of 16 and src, dst 16 B aligned.
// Each block is cut into `pieces` contiguous pieces, a power of two, the
// most that keep n_blocks * pieces within two CTAs a SM with every piece a
// multiple of 16 B.
extern "C" int xf_lab_scale_blocks(const void* src, void* dst, long long n_blocks,
                                   int block_floats, float scale, void* stream) {
  if (n_blocks > 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    int pieces = 1;
    while (n_blocks * pieces * 2 <= 2LL * sms && block_floats % (pieces * 8) == 0) pieces *= 2;
    const int piece_floats = block_floats / pieces;
    size_t smem = (size_t)piece_floats * 4 + SMEM_SLACK;
    err = allow_smem(scale_blocks_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    scale_blocks_kernel<<<(unsigned)(n_blocks * pieces), THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)src, (float*)dst, piece_floats, scale);
  }
  return (int)cudaGetLastError();
}

// #8 / #9 over `grid` slices of `pieces` column pieces each (a power of
// two; chunk / pieces a multiple of 4 and at most 256, a TMA box's limit:
// `ops/lab.py::col_pieces`). The source map and the map of the tiles as
// [grid*rows, chunk] share the box [rows, chunk / pieces]. A map that does
// not encode returns minus its CUresult (NO_ENCODER without an encoder) and
// launches nothing.
extern "C" int xf_lab_dma_cols(const void* src, int is_int, const void* off, void* tiles,
                               void* scalars, int rows, long long cols, int chunk, int grid,
                               int pieces, void* stream) {
  const int width = chunk / pieces;
  int chunk_shift = -1;
  for (int b = 0; b < 31; ++b)
    if (chunk == 1 << b) chunk_shift = b;
  // rows * width / 4 words a piece: at most 256 * 64 < 2^16, where the
  // product with 2^31 / q rounded up, shifted by 31, divides by q exactly
  const uint64_t q = (uint64_t)(width / 4);
  const uint32_t q_magic = (uint32_t)(((1ull << 31) + q - 1) / q);
  CUtensorMap src_map, out_map;
  int r = encode_2d(&src_map, src, is_int, cols, rows, cols * 4, width, rows);
  if (r == 0)
    r = encode_2d(&out_map, tiles, is_int, chunk, (long long)grid * rows, (long long)chunk * 4,
                  width, rows);
  if (r != 0) return -r;
  size_t smem = (size_t)rows * width * 4 + SMEM_SLACK;
  cudaError_t err = allow_smem(dma_cols_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dma_cols_kernel<<<dim3(pieces, grid), WARP, smem, (cudaStream_t)stream>>>(
      src_map, out_map, (const int32_t*)off, (uint32_t*)tiles, (uint32_t*)scalars, rows, cols,
      chunk, chunk_shift, width, q_magic);
  return (int)cudaGetLastError();
}

// #10 over `grid` slices of `pieces` row pieces each (chunk / pieces a
// multiple of 4: `ops/lab.py::row_pieces`). src and tiles must be 16 B
// aligned and n_rows * row_floats * 4 a multiple of 16 (so every enclosing
// span stays inside the array). Shared memory: the span, a piece and up
// to 16 B.
extern "C" int xf_lab_dma_rows(const void* src, const void* off, void* tiles, void* scalars,
                               long long n_rows, int row_floats, int chunk, int grid, int pieces,
                               void* stream) {
  const int piece_rows = chunk / pieces;
  size_t smem = (size_t)piece_rows * row_floats * 4 + 16 + SMEM_SLACK;
  cudaError_t err = allow_smem(dma_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dma_rows_kernel<<<dim3(pieces, grid), WARP, smem, (cudaStream_t)stream>>>(
      (const float*)src, (const int32_t*)off, (float*)tiles, (float*)scalars, n_rows, row_floats,
      chunk, piece_rows);
  return (int)cudaGetLastError();
}
