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
// once (47.3 + 4.7 MB at nbuf * cap = 1,183,744): 0.0656 ms at 3.35 TB/s.
//
// Design: the staged walk of scatter_staged.cuh: tile offsets marked in
// each buffer from the slots, then persistent blocks that keep a 256-slot
// tile's [256, K] sums in shared memory, stage the tile's spans of all the
// buffers (about 18 positions each at the main path's shape) in shared
// memory by 16 B asynchronous copies, buffer after buffer in one chunk
// (the next chunk in flight while this one is summed), add each (slot,
// channel)'s runs in stream order and write the tile once with 16 B
// stores. The TPU kernel accumulates the window's gradient block over the
// buffers' chunks with one-hot MXU contractions; here no two threads
// touch one sum at once and no atomics are needed, so the bits repeat
// from run to run.
//
// Measured by chip_smoke.py at the MVM segment side's inputs (v [2^22,
// 10], 4 x 295,936 positions) on an NVIDIA H100 80GB HBM3, 700.00 W:
// 0.1510 ms (43% of the bound; zeros + index_add_ 0.2040 ms, torch.zeros
// alone 0.0536). The earlier design (runs marked in global memory, each
// (slot, channel) summed across the four buffers by 4 B loads from global
// memory) took 0.4857 ms.

#include "scatter_staged.cuh"

// Slots a tile at k channels (0 if k is outside [1, 2048]): toff holds
// nbuf * (num_slots / tile + 1) int32 of scratch.
extern "C" int xf_scatter_sorted_multi_tile(int k) { return xf_staged::tile_slots(k); }

// num_slots must be a multiple of 2048, 1 <= nbuf <= 112, cap a multiple
// of 512, d and slots 16 B aligned and 1 <= k <= 2048 (the wrapper checks
// them).
extern "C" int xf_scatter_sorted_multi(const void* d, const void* slots, void* toff, void* out,
                                       long long num_slots, int k, long long np, int nbuf,
                                       long long cap, int bf16, void* stream) {
  return xf_staged::launch((const float*)d, (const int32_t*)slots, (int32_t*)toff, (float*)out,
                           num_slots, k, np, nbuf, cap, bf16, (cudaStream_t)stream);
}
