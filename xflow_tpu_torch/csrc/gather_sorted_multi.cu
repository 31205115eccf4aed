// Multi-buffer windowed sorted gather for Hopper (sm_90a): the forward of
// `table_gather_sorted_multi`, replacing the TPU kernel
// `_gather_pallas_multi` (xflow_tpu/ops/sorted_table.py,
// `_gather_kernel_multi` -> `_gather_span`).
//
// Input: nbuf concatenated buffers of cap plan positions each, every
// buffer slot-sorted on its own over the same table (the NS sub-batch
// plans of one batch, `plan_sorted_stacked`). The TPU kernel walks each
// buffer's span of a table window from loc_off [nbuf, S / 2048 + 1]; this
// one needs no window offsets.
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
// position; no arithmetic to speak of (133.2 MB, 0.0398 ms at 3.35 TB/s
// at the MVM segment side's S = 2^22, K = 10, 4 x 295,936 positions).
//
// Design: the flat walk of `gather_flat.cuh` over the flattened stream,
// a thread a position in stream order (8 B row pairs at even K,
// evict-first stores), the body #1 (`gather_sorted.cu`) launches too.
// L2 keeps a row that several sub-batches share between their reads when
// the buffers are walked one after another. Measured at the MVM segment
// shape (`chip_smoke.py`, NVIDIA H100 80GB HBM3, 700.00 W): 0.0767 ms,
// 52% of the bound, #1 on the same stream 0.0775.
//
// Tried and measured slower (the same script and card, two turns of one
// run): the TPU kernel's window-major order made dense (persistent blocks
// over windows gridDim apart, every buffer's span of a window walked as
// one list through a shared-memory prefix and a binary search, the next
// window's spans and slots in flight) 0.0953 / 0.0923 ms against the
// flat walk's 0.0778 / 0.0776; the first port's lane-per-buffer walk
// 0.1008 / 0.1019. The dense walk buys nothing that L2 does not already
// give, and pays for the search and a 102-register thread.

#include "gather_flat.cuh"

// k8 a multiple of 8, np = nbuf * cap (the wrapper checks both).
extern "C" int xf_gather_sorted_multi(const void* table, const void* slots, void* out,
                                      long long num_slots, int k, int k8, long long np,
                                      int bf16, void* stream) {
  return xf_gather_flat::launch(table, slots, out, num_slots, k, k8, np, bf16, stream);
}
