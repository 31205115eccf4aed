// Occurrence -> row reduction for Hopper (sm_90a): the forward of
// `row_sums_sorted`, replacing the TPU kernel `_rowsum_pallas`
// (xflow_tpu/ops/sorted_table.py, `_rowsum_kernel_factory`).
//
// Contract:  out[r, c] += vals[c, j]  for every j with rows[j] = r
// vals float32 [ch, Np], rows int32 [Np], out float32 [B, ch], zeroed by
// the caller. Rows outside [0, B) are skipped. Pads carry row 0 and value
// 0 by the plan contract, so they add nothing.
//
// Bound on the H100: bytes. Np * (ch + 1) * 4 B read, B * ch * 4 B
// written; one add per value.
//
// Design: the occurrences arrive in slot order, so their rows are
// scattered over [0, B) and one row's occurrences are spread over the
// whole stream. A block takes a tile of TILE occurrences: it reads the
// tile's [ch, TILE] slab of vals with coalesced loads along j into shared
// memory, then walks the slab channel-fastest, so consecutive threads
// atomically add into consecutive floats of one output row. Zero values
// (masked occurrences and pads) are skipped: adding +0 never changes a
// sum. Float atomics add in whatever order the blocks reach an address,
// so the low bits of a sum can differ from run to run; a deterministic
// form (a host row order, or a segmented reduction over a row-sorted
// permutation) is later work.
//
// The slab takes ch * TILE * 4 B of dynamic shared memory: above the
// 48 KB every kernel gets (ch > 96), the launch opts the kernel in to
// more, up to the card's per-block limit (227 KB on the H100: ch <= 454).
// `xf_row_sums_max_ch` reports that limit for the current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;

__global__ void row_sums_kernel(const float* __restrict__ vals,
                                const int32_t* __restrict__ rows,
                                float* __restrict__ out, int ch, long long np,
                                long long num_rows) {
  extern __shared__ float slab[];  // [ch][TILE]
  long long j0 = (long long)blockIdx.x * TILE;
  int n = (int)((np - j0) < TILE ? (np - j0) : TILE);
  for (int idx = threadIdx.x; idx < ch * TILE; idx += blockDim.x) {
    int c = idx / TILE, t = idx % TILE;
    slab[idx] = t < n ? __ldg(vals + (long long)c * np + j0 + t) : 0.0f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * ch; idx += blockDim.x) {
    int t = idx / ch, c = idx % ch;
    float v = slab[c * TILE + t];
    int32_t r = __ldg(rows + j0 + t);
    if (v != 0.0f && r >= 0 && (long long)r < num_rows)
      atomicAdd(out + (long long)r * ch + c, v);
  }
}

}  // namespace

extern "C" int xf_row_sums_smem_bytes(int ch) { return ch * TILE * (int)sizeof(float); }

// The largest ch whose slab fits the current device's opt-in shared
// memory a block; 0 with the CUDA error negated on failure.
extern "C" int xf_row_sums_max_ch() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  return optin / (TILE * (int)sizeof(float));
}

extern "C" int xf_row_sums(const void* vals, const void* rows, void* out, int ch,
                           long long np, long long num_rows, void* stream) {
  if (np > 0) {
    long long blocks = (np + TILE - 1) / TILE;
    size_t smem = (size_t)ch * TILE * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          row_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    row_sums_kernel<<<(unsigned)blocks, 256, smem, (cudaStream_t)stream>>>(
        (const float*)vals, (const int32_t*)rows, (float*)out, ch, np, num_rows);
  }
  return (int)cudaGetLastError();
}
