// Multi-buffer windowed sorted gather for Hopper (sm_90a): the forward of
// `table_gather_sorted_multi`, replacing the TPU kernel
// `_gather_pallas_multi` (xflow_tpu/ops/sorted_table.py,
// `_gather_kernel_multi` -> `_gather_span`).
//
// Input: nbuf concatenated buffers of cap plan positions each, every
// buffer slot-sorted on its own over the same table (the NS sub-batch
// plans of one batch, `plan_sorted_stacked`). loc_off int32
// [nbuf, S / 2048 + 1] holds each buffer's window offsets, local to the
// buffer, with loc_off[i, 0] = 0 and loc_off[i, S / 2048] = cap: buffer
// i's positions of table window w are
// [i * cap + loc_off[i, w], i * cap + loc_off[i, w + 1]). The first
// window's span starts at the buffer's start and the last window's ends
// at its end whatever those two columns hold, so every position of every
// buffer is written (a position past the last window holds a slot >= S
// in a sorted buffer, and gives 0).
//
// Contract (the same as `_gather_xla` over the flattened stream):
//   out[c, j] = table[slots[j], c]   for c < K and 0 <= slots[j] < S
//   out[c, j] = 0                    for K <= c < K8, or slot out of range
// table is logical float32 [S, K] row-major, slots int32 [nbuf * cap],
// out float32 [K8, nbuf * cap]. With bf16 != 0 each value is rounded to
// bfloat16 (round-to-nearest-even) and widened back to float32.
//
// Bound on the H100: bytes. Each distinct table row's 32 B sectors read
// once for all buffers, a 4 B slot read and K8 floats written per
// position; no arithmetic to speak of.
//
// Design: window-major, as the TPU kernel is. A block owns table window
// w and walks every buffer's span of it: the block is SPAN_LANES lanes
// of 128 threads, lane y taking buffers y, y + SPAN_LANES, ..., so the
// spans of a window (about 145 positions each at the MVM shape) run
// side by side. Within a span one thread per position copies its row
// down the output column (for every channel a warp stores 32 consecutive
// floats). A row that several sub-batches share is read by one block
// close together in time, so its second and later reads hit L1/L2
// instead of device memory. The TPU kernel streams each window's table
// block into VMEM once; on the card the caches take the place of that
// staged block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPAN_THREADS = 128;  // threads walking one buffer's span
constexpr int SPAN_LANES = 4;      // spans walked side by side

__global__ void __launch_bounds__(SPAN_THREADS * SPAN_LANES)
gather_sorted_multi_kernel(const float* __restrict__ table,
                           const int32_t* __restrict__ slots,
                           const int32_t* __restrict__ loc_off,
                           float* __restrict__ out, long long num_slots, int k,
                           int k8, long long np, int nbuf, long long cap,
                           long long n_win, int bf16) {
  long long w = blockIdx.x;
  for (int i = threadIdx.y; i < nbuf; i += blockDim.y) {
    const int32_t* off = loc_off + (long long)i * (n_win + 1);
    long long base = (long long)i * cap;
    long long lo = w == 0 ? base : base + __ldg(off + w);
    long long hi = w == n_win - 1 ? base + cap : base + __ldg(off + w + 1);
    for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
      int32_t s = __ldg(slots + j);
      bool in_range = s >= 0 && (long long)s < num_slots;
      const float* row = table + (in_range ? (long long)s * k : 0);
      for (int c = 0; c < k; ++c) {
        float v = in_range ? __ldg(row + c) : 0.0f;
        if (bf16) v = __bfloat162float(__float2bfloat16_rn(v));
        out[(long long)c * np + j] = v;
      }
      for (int c = k; c < k8; ++c) out[(long long)c * np + j] = 0.0f;
    }
  }
}

}  // namespace

// num_slots must be a multiple of 2048 (the wrapper checks it).
extern "C" int xf_gather_sorted_multi(const void* table, const void* slots,
                                      const void* loc_off, void* out, long long num_slots,
                                      int k, int k8, long long np, int nbuf, long long cap,
                                      int bf16, void* stream) {
  long long n_win = num_slots / 2048;
  if (n_win > 0 && np > 0) {
    dim3 block(SPAN_THREADS, SPAN_LANES);
    gather_sorted_multi_kernel<<<(unsigned)n_win, block, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int32_t*)slots, (const int32_t*)loc_off, (float*)out,
        num_slots, k, k8, np, nbuf, cap, n_win, bf16);
  }
  return (int)cudaGetLastError();
}
