// The search-and-sum walk of the fused scatter + FTRL kernel for Hopper
// (sm_90a), `scatter_ftrl.cu` (#3). (The plain scatters #4 and #6 take the
// staged walk of `scatter_staged.cuh`.)
//
// #3 walks the dense [S, K] state in tiles of TILE consecutive slots,
// one block per tile. The plan is slot-sorted, so each slot's
// occurrences form one contiguous run of plan positions inside its
// window's span win_off[w] .. win_off[w + 1] (w = slot / WINDOW). A block
// first finds the TILE + 1 run boundaries of its slots by binary search
// in that span (one search per thread, into shared memory), then each
// thread sums whole runs for (slot, channel) outputs in plan order: no
// float atomics, so every result is the same from run to run. Outputs
// are indexed slot-major with the channel fastest, so a warp's loads
// and stores of the [S, K] state are contiguous.
//
// Known limit: a (slot, channel) thread sums its run serially from
// global memory, so a hot slot shared by every row of a batch (a run of
// up to B occurrences) serialises its block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xf_scatter {

constexpr long long WINDOW = 2048;  // slots per window of the plan's win_off
constexpr int TILE = 256;           // slots per block; divides WINDOW
constexpr int THREADS = 256;

// First position in [lo, hi) whose slot is >= key (slots ascending).
__device__ __forceinline__ long long lower_bound(const int32_t* __restrict__ slots,
                                                 long long lo, long long hi,
                                                 long long key) {
  while (lo < hi) {
    long long mid = lo + ((hi - lo) >> 1);
    if ((long long)__ldg(slots + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// run[t] = first plan position of slot s0 + t, for t in [0, TILE]. The
// tile lies inside one window, and run[TILE] is the next tile's first
// position (the window's end for the last tile of a window). Slots
// outside [0, S) fall outside every window's span and are dropped.
__device__ __forceinline__ void tile_runs(const int32_t* __restrict__ slots,
                                          const int32_t* __restrict__ win_off,
                                          long long s0, long long* run) {
  long long w = s0 / WINDOW;
  long long lo = __ldg(win_off + w), hi = __ldg(win_off + w + 1);
  for (int t = threadIdx.x; t <= TILE; t += blockDim.x)
    run[t] = lower_bound(slots, lo, hi, s0 + t);
  __syncthreads();
}

// acc plus d[c, j0 .. j1), added in plan order; with bf16 != 0 each term
// is rounded to bfloat16 (round-to-nearest-even) before the float32 add,
// as the TPU kernel's single bf16 MXU pass does. Pads and masked
// occurrences carry d = 0 and add 0.
__device__ __forceinline__ float run_add(float acc, const float* __restrict__ d,
                                         long long np, int c, long long j0, long long j1,
                                         int bf16) {
  const float* dc = d + (long long)c * np;
  for (long long j = j0; j < j1; ++j) {
    float v = __ldg(dc + j);
    if (bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    acc = __fadd_rn(acc, v);
  }
  return acc;
}

// Sum of d[c, j0 .. j1) in plan order, from 0.
__device__ __forceinline__ float run_sum(const float* __restrict__ d, long long np,
                                         int c, long long j0, long long j1, int bf16) {
  return run_add(0.0f, d, np, c, j0, j1, bf16);
}

}  // namespace xf_scatter
