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
// Design: the flat walk of `gather_flat.cuh`, a thread an occurrence
// (shared with the multi-buffer gather, `gather_sorted_multi.cu`). The
// window offsets the TPU kernel needs to stream table blocks through VMEM
// have no use here: the card's L2 takes the place of the staged window.

#include "gather_flat.cuh"

// k8 a multiple of 8 (the wrapper's `_k8`).
extern "C" int xf_gather_sorted(const void* table, const void* slots, void* out,
                                long long num_slots, int k, int k8, long long np,
                                int bf16, void* stream) {
  return xf_gather_flat::launch(table, slots, out, num_slots, k, k8, np, bf16, stream);
}
