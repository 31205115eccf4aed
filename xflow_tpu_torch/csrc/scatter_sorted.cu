// Windowed sorted scatter-add for Hopper (sm_90a): the backward of
// `table_gather_sorted`, replacing the TPU kernel `_scatter_pallas`
// (xflow_tpu/ops/sorted_table.py, `_scatter_kernel` -> `_scatter_span`).
//
// Contract (the same as `_scatter_xla`):
//   out[s, c] = sum over plan positions j with slots[j] = s of d[c, j]
// for 0 <= s < S and c < K; rows K..K8 of d are ignored, slots outside
// [0, S) are dropped. d is float32 [K8, Np] row-major, slots int32 [Np]
// sorted ascending, win_off int32 [S / 2048 + 1] the plan's window
// offsets, out float32 [S, K] (every element written). With bf16 != 0
// each term is rounded to bfloat16 before the float32 sum.
//
// Bound on the H100: bytes. The dense gradient is written once (S * K
// floats, 184.5 MB at S = 2^22, K = 11) and d[:K] and the slots are read
// once (51.9 + 4.7 MB at Np = 1,180,672); one add per term.
//
// Design: see scatter_window.cuh. The TPU kernel builds each 2048-slot
// window's gradient block with one-hot MXU contractions over the
// window's occurrence chunks; here a block owns TILE slots of a window,
// finds their runs by binary search and sums each (slot, channel) run
// in plan order, so no two threads write one output and no atomics are
// needed.

#include "scatter_window.cuh"

namespace {

using namespace xf_scatter;

__global__ void __launch_bounds__(THREADS)
scatter_sorted_kernel(const float* __restrict__ d, const int32_t* __restrict__ slots,
                      const int32_t* __restrict__ win_off, float* __restrict__ out,
                      int k, long long np, int bf16) {
  __shared__ long long run[TILE + 1];
  long long s0 = (long long)blockIdx.x * TILE;
  tile_runs(slots, win_off, s0, run);
  float* o = out + s0 * k;
  for (int i = threadIdx.x; i < TILE * k; i += blockDim.x) {
    int t = i / k, c = i - t * k;
    o[i] = run_sum(d, np, c, run[t], run[t + 1], bf16);
  }
}

}  // namespace

// num_slots must be a multiple of 2048 (the wrapper checks it).
extern "C" int xf_scatter_sorted(const void* d, const void* slots, const void* win_off,
                                 void* out, long long num_slots, int k, long long np,
                                 int bf16, void* stream) {
  if (num_slots > 0) {
    unsigned blocks = (unsigned)(num_slots / xf_scatter::TILE);
    scatter_sorted_kernel<<<blocks, xf_scatter::THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)d, (const int32_t*)slots, (const int32_t*)win_off, (float*)out, k,
        np, bf16);
  }
  return (int)cudaGetLastError();
}
