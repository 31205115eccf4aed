// Multi-buffer windowed sorted scatter-add for Hopper (sm_90a): the
// backward of `table_gather_sorted_multi`, replacing the TPU kernel
// `_scatter_pallas_multi` (xflow_tpu/ops/sorted_table.py,
// `_scatter_kernel_multi` -> `_scatter_span`).
//
// Input: nbuf concatenated buffers of cap plan positions each, every
// buffer slot-sorted on its own over the same table; loc_off int32
// [nbuf, S / 2048 + 1] buffer-local window offsets (see
// gather_sorted_multi.cu: the first window's span starts at the buffer's
// start, the last one's ends at the buffer's end).
//
// Contract (the same as `_scatter_xla` over the flattened stream):
//   out[s, c] = sum over positions j with slots[j] = s of d[c, j]
// for 0 <= s < S and c < K; rows K..K8 of d are ignored, slots outside
// [0, S) are dropped. d is float32 [K8, nbuf * cap] row-major, out
// float32 [S, K] (every element written). The terms of a slot are added
// in stream order: its run in buffer 0, then in buffer 1, and so on,
// each in plan order, from 0 (the order of `index_add_` on the CPU).
// With bf16 != 0 each term is rounded to bfloat16 before the float32 add.
//
// Bound on the H100: bytes. The dense gradient is written once (S * K
// floats, 167.8 MB at S = 2^22, K = 10) and d[:K] and the slots are read
// once (47.3 + 4.7 MB at nbuf * cap = 1,183,744); one add per term.
//
// Design: the walk of scatter_window.cuh with a loop over buffers. A
// block owns TILE slots of one window and first finds the TILE + 1 run
// boundaries of its slots in each buffer's span of the window, into
// shared memory (nbuf * (TILE + 1) positions): run[t] is the first
// position whose slot is >= s0 + t. Every boundary starts at its span's
// end, and each position j of the span, read once with its neighbour
// j - 1 (coalesced), writes run[t] = j for the t in
// (slot[j-1], slot[j]] - s0 that fall in the tile: the first position
// at or past a slot is its run's start, and exactly one position owns
// each boundary. (Binary searches, as the single-buffer scatter does
// them, chain about eight dependent loads per boundary, four times over;
// this marking measured faster.) The block's threads form LANES lanes
// that walk buffers lane, lane + LANES, ... side by side. Then each
// thread sums whole (slot, channel) runs across all buffers in a
// register, slot-major with the channel fastest, and writes the output
// once. The TPU kernel accumulates the window's gradient block over the
// buffers' chunks with one-hot MXU contractions; here no two threads
// write one output and no atomics are needed, so the bits repeat from
// run to run. Known cost: the sums, which read d one term at a time
// across ten channel rows and four buffers, take most of the time.

#include "scatter_window.cuh"

namespace {

using namespace xf_scatter;

constexpr int LANE_THREADS = 64;  // threads walking one buffer's span
constexpr int LANES = 4;          // spans walked side by side
constexpr int MULTI_THREADS = LANE_THREADS * LANES;

// Buffer i's positions of window w: [*lo, *hi). The first window's span
// starts at the buffer's start and the last one's ends at its end.
__device__ __forceinline__ void buffer_span(const int32_t* __restrict__ loc_off, int i,
                                            long long w, long long n_win, long long cap,
                                            long long* lo, long long* hi) {
  const int32_t* off = loc_off + (long long)i * (n_win + 1);
  long long base = (long long)i * cap;
  *lo = w == 0 ? base : base + __ldg(off + w);
  *hi = w == n_win - 1 ? base + cap : base + __ldg(off + w + 1);
}

__global__ void __launch_bounds__(MULTI_THREADS)
scatter_sorted_multi_kernel(const float* __restrict__ d, const int32_t* __restrict__ slots,
                            const int32_t* __restrict__ loc_off, float* __restrict__ out,
                            int k, long long np, int nbuf, long long cap, long long n_win,
                            int bf16) {
  extern __shared__ long long runs[];  // [nbuf][TILE + 1]
  long long s0 = (long long)blockIdx.x * TILE;
  long long w = s0 / WINDOW;
  long long lo, hi;
  for (int e = threadIdx.x; e < nbuf * (TILE + 1); e += blockDim.x) {
    buffer_span(loc_off, e / (TILE + 1), w, n_win, cap, &lo, &hi);
    runs[e] = hi;  // no slot >= s0 + t in the span: the run starts at its end
  }
  __syncthreads();
  int lane = threadIdx.x / LANE_THREADS, x = threadIdx.x - lane * LANE_THREADS;
  for (int i = lane; i < nbuf; i += LANES) {
    buffer_span(loc_off, i, w, n_win, cap, &lo, &hi);
    long long* run = runs + (long long)i * (TILE + 1);
    for (long long j = lo + x; j < hi; j += LANE_THREADS) {
      long long s = __ldg(slots + j);
      long long prev = j == lo ? s0 - 1 : (long long)__ldg(slots + j - 1);
      long long t0 = prev + 1 - s0 > 0 ? prev + 1 - s0 : 0;
      long long t1 = s - s0 < TILE ? s - s0 : TILE;
      for (long long t = t0; t <= t1; ++t) run[t] = j;
    }
  }
  __syncthreads();
  float* o = out + s0 * k;
  for (int e = threadIdx.x; e < TILE * k; e += blockDim.x) {
    int t = e / k, c = e - t * k;
    float acc = 0.0f;
    for (int i = 0; i < nbuf; ++i) {
      const long long* run = runs + (long long)i * (TILE + 1);
      acc = run_add(acc, d, np, c, run[t], run[t + 1], bf16);
    }
    o[e] = acc;
  }
}

}  // namespace

// num_slots must be a multiple of 2048 and 1 <= nbuf <= 112 (the wrapper
// checks both: the run table takes 2,056 B of shared memory a buffer).
extern "C" int xf_scatter_sorted_multi(const void* d, const void* slots, const void* loc_off,
                                       void* out, long long num_slots, int k, long long np,
                                       int nbuf, long long cap, int bf16, void* stream) {
  if (num_slots > 0) {
    size_t smem = (size_t)nbuf * (xf_scatter::TILE + 1) * sizeof(long long);
    cudaError_t err = cudaFuncSetAttribute(
        scatter_sorted_multi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    unsigned blocks = (unsigned)(num_slots / xf_scatter::TILE);
    scatter_sorted_multi_kernel<<<blocks, MULTI_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)d, (const int32_t*)slots, (const int32_t*)loc_off, (float*)out, k, np,
        nbuf, cap, num_slots / xf_scatter::WINDOW, bf16);
  }
  return (int)cudaGetLastError();
}
