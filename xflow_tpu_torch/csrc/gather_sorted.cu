// Windowed sorted gather for Hopper (sm_90a): the forward of
// `table_gather_sorted`, replacing the TPU kernel `_gather_pallas`
// (xflow_tpu/ops/sorted_table.py, `_gather_kernel` -> `_gather_span`).
//
// Contract (the same as `_gather_xla`):
//   out[c, j] = table[slots[j], c]   for c < K and 0 <= slots[j] < S
//   out[c, j] = 0                    for K <= c < K8, or slot out of range
// table is logical float32 [S, K] row-major, slots int32 [Np], out float32
// [K8, Np]. With bf16 != 0 each value is rounded to bfloat16
// (round-to-nearest-even) and widened back to float32.
//
// Bound on the H100: bytes. Each occurrence reads a 4 B slot and one
// K-float table row (44 B for the fused FM row, one or two 32 B sectors),
// and writes K8 floats; no arithmetic to speak of.
//
// Design: one thread per occurrence j. The thread reads its slot and
// copies the row's K floats down column j of the output, so for every
// channel c a warp writes 32 consecutive floats (coalesced 128 B stores).
// The slot-sorted order makes neighbouring threads read neighbouring or
// equal rows, so row reads hit the same L2 sectors. The window offsets
// the TPU kernel needs to stream table blocks through VMEM have no use
// here: the card's L2 takes the place of the staged window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_sorted_kernel(const float* __restrict__ table,
                                     const int32_t* __restrict__ slots,
                                     float* __restrict__ out, long long num_slots,
                                     int k, int k8, long long np, int bf16) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= np) return;
  int32_t s = slots[j];
  bool in_range = s >= 0 && (long long)s < num_slots;
  const float* row = table + (in_range ? (long long)s * k : 0);
  for (int c = 0; c < k; ++c) {
    float v = in_range ? __ldg(row + c) : 0.0f;
    if (bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    out[(long long)c * np + j] = v;
  }
  for (int c = k; c < k8; ++c) out[(long long)c * np + j] = 0.0f;
}

}  // namespace

extern "C" int xf_gather_sorted(const void* table, const void* slots, void* out,
                                long long num_slots, int k, int k8, long long np,
                                int bf16, void* stream) {
  if (np > 0) {
    const int threads = 256;
    long long blocks = (np + threads - 1) / threads;
    gather_sorted_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int32_t*)slots, (float*)out, num_slots, k, k8,
        np, bf16);
  }
  return (int)cudaGetLastError();
}
