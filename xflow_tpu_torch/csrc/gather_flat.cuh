// The flat sorted gather (sm_90a), the one body of two kernels:
// `gather_sorted.cu` (#1, `_gather_pallas`) and `gather_sorted_multi.cu`
// (#5, `_gather_pallas_multi`, over the flattened stream of its stacked
// buffers). Each keeps its own entry point and launch count.
//
// Contract (the same as `_gather_xla`):
//   out[c, j] = table[slots[j], c]   for c < K and 0 <= slots[j] < S
//   out[c, j] = 0                    for K <= c < K8, or slot out of range
// table is logical float32 [S, K] row-major, slots int32 [Np], out float32
// [K8, Np], K8 a multiple of 8. With bf16 != 0 each value is rounded to
// bfloat16 (round-to-nearest-even) and widened back to float32.
//
// Design: a thread a position j, in stream order, 256 a block. It reads
// its slot, then its row: 8 B pairs when K is even and the table 8 B
// aligned (MVM's K = 10), scalar loads otherwise (FM's fused K = 11). It
// stores the row down column j of the output eight channels at a time, so
// for every channel a warp writes 32 consecutive floats (coalesced), with
// evict-first stores so that the output does not push table rows out of
// L2. The slot-sorted order makes neighbouring threads read neighbouring
// or equal rows; L2 (50 MB) takes the place of the VMEM window the TPU
// kernels stage, and keeps a row that several sub-batches share between
// their reads, so the window offsets are not read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xf_gather_flat {

constexpr int THREADS = 256;

struct Args {
  const float* table;
  const int32_t* slots;
  float* out;
  long long num_slots, np;
  int k, k8, bf16;
};

__device__ __forceinline__ float round_bf16(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool PAIRS>
__global__ void __launch_bounds__(THREADS, 8) gather_flat(const Args a) {
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j >= a.np) return;
  const int32_t s = __ldg(a.slots + j);
  const bool ok = s >= 0 && (long long)s < a.num_slots;
  const float* row = a.table + (ok ? (long long)s * a.k : 0);
  for (int c0 = 0; c0 < a.k8; c0 += 8) {
    float v[8];
#pragma unroll
    for (int p = 0; p < 8; p += 2) {
      const int c = c0 + p;
      if (PAIRS) {  // k even: c < k covers c + 1 too
        float2 x = make_float2(0.0f, 0.0f);
        if (ok && c < a.k) x = __ldg(reinterpret_cast<const float2*>(row + c));
        v[p] = x.x;
        v[p + 1] = x.y;
      } else {
        v[p] = ok && c < a.k ? __ldg(row + c) : 0.0f;
        v[p + 1] = ok && c + 1 < a.k ? __ldg(row + c + 1) : 0.0f;
      }
    }
#pragma unroll
    for (int p = 0; p < 8; ++p)
      __stcs(a.out + (long long)(c0 + p) * a.np + j, round_bf16(v[p], a.bf16));
  }
}

// One launch over np positions on `stream`; the launch's CUDA error.
inline int launch(const void* table, const void* slots, void* out, long long num_slots, int k,
                  int k8, long long np, int bf16, void* stream) {
  if (np <= 0) return (int)cudaGetLastError();
  if (k8 % 8) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)table, (const int32_t*)slots, (float*)out, num_slots, np,
               k, k8, bf16};
  const unsigned blocks = (unsigned)((np + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (k % 2 == 0 && ((uintptr_t)table & 7) == 0)
    gather_flat<true><<<blocks, THREADS, 0, s>>>(a);
  else
    gather_flat<false><<<blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace xf_gather_flat
