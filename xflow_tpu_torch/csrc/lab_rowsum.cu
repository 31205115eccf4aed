// The Hopper lab's row-reduction probe (sm_90a): kernel #11, the
// counterpart of `suite_rowsum`'s `rowsum_pallas`
// (xflow_tpu/tools/bench_lab.py:714, kernel body :686).
//
// Contract:  out[r, c] += vals[c, j]  for every j with rows[j] = r
// vals float32 [ch, Np], rows int32 [Np] (any order), out float32 [B, ch],
// zeroed by the caller; ch a multiple of 4; any B. Rows outside [0, B)
// are skipped.
//
// Bound on the H100: bytes. Np * (ch + 1) * 4 B read, B * ch * 4 B
// written (216 MB, 0.0645 ms at 3.35 TB/s for the suite's B 65,536, ch 24,
// Np 2,098,176); one add per value.
//
// Design: a grid-stride loop over (position, quad) pairs, quads fastest,
// with the card's resident threads (SMs x threads an SM). A thread reads
// its position's row and its quad's four channels (each a coalesced read
// along the positions across the warp) and sends a nonzero quad of an
// in-range row to device memory with one `red.global.add.v4.f32` (PTX ISA
// 8.1, sm_90): an output row is 16 B aligned at ch % 4 == 0. A warp's 32
// reductions fall on about five rows' neighbouring addresses. One
// reduction a nonzero quad: 12.59 M a batch at the suite's shape.
// Measured there (`tools/bench_lab.py --suite rowsum` in `chip_smoke.py`,
// NVIDIA H100 80GB HBM3, 700.00 W): 0.1533 ms, 42% of the bound, #2
// (`row_sums.cu`) 0.1564 on the same inputs.
//
// The lab's question, whether fewer L2 reductions pay, was answered on
// the same inputs, script and card: no. Sums privatised in a cluster of
// 8 blocks' distributed shared memory (one quad's sums of up to 65,536
// rows, one reduction a nonzero row at the flush: at most 1.18 M a
// batch) took 0.4932 / 0.4828 ms with an outbox the owners pull from
// after a cluster barrier, 1.3285 / 1.2892 ms with four scalar DSMEM
// atomicAdds a quad (a float atomicAdd on shared memory is a
// compare-and-swap loop on sm_90), against 0.1529 / 0.1431 for these
// reductions from 8-block groups over a host plan's position shares, and
// the first port's staged [ch, 128] slab 0.1762 / 0.1681. Float
// reductions reorder the sums, so the last bits vary from run to run
// (tolerance: the float32 reorder bound, `tools/bench_lab.py::reorder_err`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void red_add_v4(float* dst, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__global__ void __launch_bounds__(THREADS)
lab_rowsum_kernel(const float* __restrict__ vals, const int32_t* __restrict__ rows,
                  float* __restrict__ out, int ch, long long np, long long num_rows) {
  const int quads = ch / 4;
  const long long n = np * quads;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * THREADS) {
    const long long j = idx / quads;
    const int g = (int)(idx % quads);
    const int32_t r = __ldg(rows + j);
    if (r < 0 || r >= num_rows) continue;
    const float* v = vals + (long long)(4 * g) * np + j;
    const float4 x = make_float4(__ldg(v), __ldg(v + np), __ldg(v + 2 * np), __ldg(v + 3 * np));
    if (x.x != 0.0f || x.y != 0.0f || x.z != 0.0f || x.w != 0.0f)
      red_add_v4(out + (long long)r * ch + 4 * g, x);
  }
}

}  // namespace

// out 16 B aligned and zeroed, ch % 4 == 0.
extern "C" int xf_lab_rowsum(const void* vals, const void* rows, void* out, int ch, long long np,
                             long long num_rows, void* stream) {
  const long long n = np * (ch / 4);
  if (n <= 0 || num_rows <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)sms * (per_sm / THREADS);
  const long long need = (n + THREADS - 1) / THREADS;
  if (blocks > need) blocks = need;
  lab_rowsum_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const int32_t*)rows, (float*)out, ch, np, num_rows);
  return (int)cudaGetLastError();
}
