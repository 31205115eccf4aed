// The Hopper lab's row-reduction probe (sm_90a): kernel #11, the
// counterpart of `suite_rowsum`'s `rowsum_pallas`
// (xflow_tpu/tools/bench_lab.py:714, kernel body :686).
//
// Contract:  out[r, c] += vals[c, j]  for every j with rows[j] = r
// vals float32 [ch, Np], rows int32 [Np] (any order), out float32 [B, ch],
// zeroed by the caller; ch a multiple of 4. Rows outside [0, B) are
// skipped.
//
// Bound on the H100: bytes. Np * (ch + 1) * 4 B read, B * ch * 4 B
// written (216 MB, 0.0645 ms at 3.35 TB/s for the suite's B 65,536, ch 24,
// Np 2,098,176); one add per value.
//
// The TPU kernel keeps two accumulators to break the scalar core's
// read-modify-write chain; the card has no such chain, so this keeps the
// function in one accumulator (a second one, odd occurrences into their
// own [B, ch] buffer folded in by a second launch, measured slower) and
// asks the card's own question: can per-float atomics give way to vector
// reductions? A block stages a tile's [ch, TILE] slab of vals through
// shared memory with coalesced loads along j (as #2, csrc/row_sums.cu,
// does), transposed to [TILE][ch] so that one occurrence's four channels
// are one 16 B shared-memory read, then adds them into the
// output row with one `red.global.add.v4.f32` (PTX ISA 8.1, sm_90): an
// output row of ch floats is 16 B aligned at ch % 4 == 0, and the
// reduction needs a quarter of #2's atomic instructions. A group of four
// zeros (masked occurrences) is skipped. Float reductions reorder the
// sums, so the last bits vary from run to run (tolerance: the float32
// reorder bound, `tools/bench_lab.py::reorder_err`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;
constexpr int THREADS = 256;

__device__ __forceinline__ void red_add_v4(float* dst, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__global__ void lab_rowsum_kernel(const float* __restrict__ vals, const int32_t* __restrict__ rows,
                                  float* __restrict__ out, int ch, long long np,
                                  long long num_rows) {
  extern __shared__ float4 slab4[];  // [TILE][ch] floats
  float* slab = reinterpret_cast<float*>(slab4);
  const long long j0 = (long long)blockIdx.x * TILE;
  const int n = (int)((np - j0) < TILE ? (np - j0) : TILE);
  for (int idx = threadIdx.x; idx < ch * TILE; idx += blockDim.x) {
    const int c = idx / TILE, t = idx % TILE;
    slab[t * ch + c] = t < n ? __ldg(vals + (long long)c * np + j0 + t) : 0.0f;
  }
  __syncthreads();
  const int groups = ch / 4;
  for (int idx = threadIdx.x; idx < n * groups; idx += blockDim.x) {
    const int t = idx / groups, g = idx % groups;
    const float4 v = slab4[(t * ch) / 4 + g];
    const int32_t r = __ldg(rows + j0 + t);
    if ((v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) && r >= 0 &&
        (long long)r < num_rows) {
      red_add_v4(out + (long long)r * ch + 4 * g, v);
    }
  }
}

}  // namespace

// out 16 B aligned, ch % 4 == 0, ch * TILE * 4 B of shared memory (ch <=
// 96 stays under the 48 KB every kernel gets; more is opted in).
extern "C" int xf_lab_rowsum(const void* vals, const void* rows, void* out, int ch, long long np,
                             long long num_rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (np > 0) {
    size_t smem = (size_t)ch * TILE * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(lab_rowsum_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    lab_rowsum_kernel<<<(unsigned)((np + TILE - 1) / TILE), THREADS, smem, s>>>(
        (const float*)vals, (const int32_t*)rows, (float*)out, ch, np, num_rows);
  }
  return (int)cudaGetLastError();
}
