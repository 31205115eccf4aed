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
//      (off[t] / C) * C: a 2-D tensor map over [R, N] (row stride N*4 B),
//      loaded as C/256 boxes of [R, 256] (a box dimension holds at most
//      256 elements). One source serves f32 (B, R 11) and i32 (C, R 1):
//      the copy moves 4 B words, so the tiles are bitwise the slices.
//   #10 (D) a [C, K] row slice of an [N, K] f32 array at the unaligned row
//      off[t]: a 1-D bulk copy of the 16 B aligned span that encloses bytes
//      [44*start, 44*(start + C)), then the shift in shared memory. No
//      tensor map can describe a 44 B row stride.
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

constexpr int BOX = 256;                      // TMA: at most 256 elements a box dimension
constexpr long long WAIT_CYCLES = 2000000000LL;  // about 1 s at the H100's clock
constexpr int THREADS = 256;
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

template <typename T>
__device__ __forceinline__ void zero_block(T* out, long long n, T* scalar) {
  for (long long i = threadIdx.x; i < n; i += blockDim.x) out[i] = T(0);
  if (threadIdx.x == 0) *scalar = T(0);
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

// #8 / #9: block t copies the [rows, chunk] column slice at
// (off[t] / chunk) * chunk of a [rows, cols] array of 4 B words through
// the tensor map, as chunk / BOX boxes of [rows, BOX] (each [rows][BOX] in
// shared memory), into tiles[t] ([rows, chunk]) and its first word into
// scalars[t].
__global__ void dma_cols_kernel(const __grid_constant__ CUtensorMap map,
                                const int32_t* __restrict__ off, uint32_t* __restrict__ tiles,
                                uint32_t* __restrict__ scalars, int rows, long long cols,
                                int chunk) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  uint32_t* tile = reinterpret_cast<uint32_t*>(aligned_tile(smem_raw));
  const int t = blockIdx.x;
  const int o = off[t];
  const long long start = (long long)(o / chunk) * chunk;
  uint32_t* out = tiles + (long long)t * rows * chunk;
  if (o < 0 || start + chunk > cols) {
    zero_block(out, (long long)rows * chunk, scalars + t);
    return;
  }
  if (threadIdx.x == 0) bar_init(&bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect_tx(&bar, (uint32_t)rows * chunk * 4u);
    for (int b = 0; b < chunk / BOX; ++b)
      tma_load_2d(tile + b * rows * BOX, &map, (int)(start + b * BOX), 0, &bar);
  }
  bar_wait(&bar, 0);
  for (int i = threadIdx.x; i < rows * chunk; i += blockDim.x) {
    const int r = i / chunk, c = i % chunk;
    out[i] = tile[(c / BOX) * rows * BOX + r * BOX + c % BOX];
  }
  if (threadIdx.x == 0) scalars[t] = tile[0];
}

// #10: block t copies rows [off[t], off[t] + chunk) of an [n_rows,
// row_floats] f32 array: one bulk copy of the enclosing 16 B aligned span,
// then the rows from their byte offset in it.
__global__ void dma_rows_kernel(const float* __restrict__ src, const int32_t* __restrict__ off,
                                float* __restrict__ tiles, float* __restrict__ scalars,
                                long long n_rows, int row_floats, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  unsigned char* span = aligned_tile(smem_raw);
  const int t = blockIdx.x;
  const long long start = off[t];
  const long long n = (long long)chunk * row_floats;
  float* out = tiles + t * n;
  if (start < 0 || start + chunk > n_rows) {
    zero_block(out, n, scalars + t);
    return;
  }
  const long long b0 = start * row_floats * 4, b1 = b0 + n * 4;
  const long long lo = b0 & ~15LL, hi = (b1 + 15) & ~15LL;
  if (threadIdx.x == 0) bar_init(&bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect_tx(&bar, (uint32_t)(hi - lo));
    bulk_load(span, reinterpret_cast<const unsigned char*>(src) + lo, (uint32_t)(hi - lo), &bar);
  }
  bar_wait(&bar, 0);
  const float* rows = reinterpret_cast<const float*>(span + (b0 - lo));
  for (long long i = threadIdx.x; i < n; i += blockDim.x) out[i] = rows[i];
  if (threadIdx.x == 0) scalars[t] = rows[0];
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

// #8 / #9 over `grid` blocks. A tensor map that does not encode returns
// minus its CUresult (NO_ENCODER without an encoder) and launches nothing.
extern "C" int xf_lab_dma_cols(const void* src, int is_int, const void* off, void* tiles,
                               void* scalars, int rows, long long cols, int chunk, int grid,
                               void* stream) {
  CUtensorMap map;
  int r = encode_2d(&map, src, is_int, cols, rows, cols * 4, BOX, rows);
  if (r != 0) return -r;
  size_t smem = (size_t)rows * chunk * 4 + SMEM_SLACK;
  cudaError_t err = allow_smem(dma_cols_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dma_cols_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      map, (const int32_t*)off, (uint32_t*)tiles, (uint32_t*)scalars, rows, cols, chunk);
  return (int)cudaGetLastError();
}

// #10 over `grid` blocks. src must be 16 B aligned and n_rows * row_floats
// * 4 a multiple of 16 (so the enclosing span stays inside the array).
extern "C" int xf_lab_dma_rows(const void* src, const void* off, void* tiles, void* scalars,
                               long long n_rows, int row_floats, int chunk, int grid,
                               void* stream) {
  size_t smem = (size_t)chunk * row_floats * 4 + 32 + SMEM_SLACK;
  cudaError_t err = allow_smem(dma_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dma_rows_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)src, (const int32_t*)off, (float*)tiles, (float*)scalars, n_rows, row_floats,
      chunk);
  return (int)cudaGetLastError();
}
