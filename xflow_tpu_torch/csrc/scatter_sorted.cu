// Windowed sorted scatter-add for Hopper (sm_90a): the backward of
// `table_gather_sorted`, replacing the TPU kernel `_scatter_pallas`
// (xflow_tpu/ops/sorted_table.py, `_scatter_kernel` -> `_scatter_span`).
//
// Contract (the same as `_scatter_xla`):
//   out[s, c] = sum over plan positions j with slots[j] = s of d[c, j]
// for 0 <= s < S and c < K; rows K..K8 of d are ignored, slots outside
// [0, S) are dropped. d is float32 [K8, Np] row-major, slots int32 [Np]
// sorted ascending, win_off int32 [S / 2048 + 1] the plan's window
// offsets, out float32 [S, K] (every element written). Each slot's terms
// are added in plan order from 0; with bf16 != 0 each term is rounded to
// bfloat16 before the float32 add.
//
// Bound on the H100: bytes. The dense gradient is written once (S * K
// floats, 184.5 MB at S = 2^22, K = 11) and d[:K] and the slots are read
// once (51.9 + 4.7 MB at Np = 1,180,672): 0.0720 ms at 3.35 TB/s.
//
// Design: the staged walk of scatter_staged.cuh with one buffer (nbuf =
// 1, cap = Np): tile offsets marked from the slots, then persistent blocks
// that stage each 256-slot tile's span of the slots and d's K rows in
// shared memory by 16 B asynchronous copies (the next chunk in flight
// while this one is summed), sum each (slot, channel) run there in plan
// order and write the [256, K] tile once with 16 B stores. The TPU kernel
// builds each 2048-slot window's gradient block with one-hot MXU
// contractions over the window's occurrence chunks.
//
// Measured by chip_smoke.py at the FM headline's inputs (wv [2^22, 11],
// Np = 1,180,672) on an NVIDIA H100 80GB HBM3, 700.00 W: 0.1212 ms (59%
// of the bound; zeros + index_add_ 0.2047 ms, torch.zeros alone 0.0586),
// 0.1154 ms on the MVM product side's [2^22, 10]. The earlier design (a
// binary search a slot, each (slot, channel) run summed by 4 B loads from
// global memory) took 0.2286 ms.

#include "scatter_staged.cuh"

// Slots a tile at k channels (0 if k is outside [1, 2048]): toff holds
// num_slots / tile + 1 int32 of scratch.
extern "C" int xf_scatter_sorted_tile(int k) { return xf_staged::tile_slots(k); }

// num_slots must be a multiple of 2048, Np of 4, d and slots 16 B
// aligned, and 1 <= k <= 2048 (the wrapper checks them). The plan's
// win_off is not read: the tile offsets are marked from the slots.
extern "C" int xf_scatter_sorted(const void* d, const void* slots, void* toff, void* out,
                                 long long num_slots, int k, long long np, int bf16,
                                 void* stream) {
  return xf_staged::launch((const float*)d, (const int32_t*)slots, (int32_t*)toff, (float*)out,
                           num_slots, k, np, 1, np, bf16, (cudaStream_t)stream);
}
