// Multi-buffer windowed sorted scatter-add for Hopper (sm_90a): the
// backward of `table_gather_sorted_multi`, replacing the TPU kernel
// `_scatter_pallas_multi` (xflow_tpu/ops/sorted_table.py,
// `_scatter_kernel_multi` -> `_scatter_span`).
//
// Input: nbuf concatenated buffers of cap plan positions each, every
// buffer slot-sorted on its own over the same table; loc_off int32
// [nbuf, S / 2048 + 1] buffer-local window offsets (checked for their
// shape by the wrapper, not read: the tile offsets come from the slots).
//
// Contract (the function of `_scatter_xla` over the flattened stream):
//   out[s, c] = sum over positions j with slots[j] = s of d[c, j]
// for 0 <= s < S and c < K; rows K..K8 of d are ignored, slots outside
// [0, S) are dropped. d is float32 [K8, nbuf * cap] row-major, out
// float32 [S, K] (every element written). With bf16 != 0 each term is
// rounded to bfloat16 before the float32 add. The order of the adds is
// scatter_staged.cuh's: a slot's items in stream order from 0 (its run in
// buffer 0, then in buffer 1, ...), a run of at most 256 positions term
// by term, a longer one as its pieces on a fixed 256-position grid of the
// stream, joined in order; the same bits on every launch.
// `scatter_sorted_multi_plain` adds in that order.
//
// Bound on the H100: bytes. The dense gradient is written once (S * K
// floats, 167.8 MB at S = 2^22, K = 10) and d[:K] and the slots are read
// once (47.3 + 4.7 MB at nbuf * cap = 1,183,744): 0.0656 ms at 3.35 TB/s.
//
// Design: the staged walk of scatter_staged.cuh: tile offsets and long
// runs marked in each buffer from the slots, long runs' pieces summed a
// warp a cell; then persistent blocks that keep a 256-slot tile's [256,
// K] sums in shared memory, stage the tile's spans of all the buffers
// (about 18 positions each at the main path's shape) by 16 B asynchronous
// copies, buffer after buffer in one chunk (the next chunk in flight
// while this one is summed), add each (slot, channel)'s short runs in
// stream order and each long run's joined pieces at its place, and write
// the tile once with 16 B stores. The TPU kernel accumulates the window's
// gradient block over the buffers' chunks with one-hot MXU contractions;
// here no two threads touch one sum at once and no atomics are needed.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W:
// 0.1582 ms at the MVM segment side's inputs (v [2^22, 10], 4 x 295,936
// positions; zeros + index_add_ 0.2059); 0.1658 with a run of 65,536 at
// one slot, 16,384 a buffer (0.4491; 1.1272 before long runs were
// split); 0.2117 on a Zipf batch's stacked plan (0.2054: at parity);
// 0.2166 on the 1 x 1 fully-sharded buffer, 1,180,160 pads at one slot
// (2.3688; 17.6 ms before). The first design (runs marked in global
// memory, summed from global memory): 0.4857 ms.

#include "scatter_staged.cuh"

// Slots a tile at k channels (0 if k is outside [1, 2048]).
extern "C" int xf_scatter_sorted_multi_tile(int k) { return xf_staged::tile_slots(k); }

// num_slots must be a multiple of 2048, 1 <= nbuf <= 112, cap a multiple
// of 512, d and slots 16 B aligned and 1 <= k <= 2048 (the wrapper checks
// them); toff and psum as for xf_scatter_sorted.
extern "C" int xf_scatter_sorted_multi(const void* d, const void* slots, void* toff,
                                       long long n_ints, void* psum, long long n_floats,
                                       void* out, long long num_slots, int k, long long np,
                                       int nbuf, long long cap, int bf16, void* stream) {
  return xf_staged::launch((const float*)d, (const int32_t*)slots, (int32_t*)toff, n_ints,
                           (float*)psum, n_floats, (float*)out, num_slots, k, np, nbuf, cap,
                           bf16, (cudaStream_t)stream);
}
