// Fused windowed scatter-add + FTRL-proximal update for Hopper (sm_90a),
// replacing the TPU kernel `_scatter_ftrl_pallas`
// (xflow_tpu/ops/sorted_table.py, `_scatter_ftrl_kernel` -> `_scatter_span`
// + xflow_tpu/optim/ftrl.py `_update_one`).
//
// Contract (the same as `scatter_ftrl_sorted`'s CPU composition, the
// scatter of scatter_sorted.cu followed by the FTRL update on every slot):
//   g[s, c] = sum over plan positions j with slots[j] = s of d[c, j]
//   (w', n', z')[s, c] = ftrl(w, n, z, g)[s, c]   for every s < S, c < K
// in one launch: g is summed in registers and never written to device
// memory. w, n, z are float32 [S, K] inputs and w', n', z' fresh float32
// [S, K] outputs (not in place: the step's non-finite guard may keep the
// pre-step state). Hyperparameters alpha, beta, lambda1, lambda2.
//
// FTRL arithmetic is `optim/ftrl.py::update_one` op for op with IEEE
// float32 operations (__f*_rn: no contraction into FMAs, correctly
// rounded sqrt and division), sign(0) = 0, and the lazy-init guard: a
// slot with g == 0 and old n == 0 keeps its w.
//
// Bound on the H100: bytes. w, n, z are read and w', n', z' written once
// (6 * S * K floats, 1,107 MB at S = 2^22, K = 11), plus d[:K] and the
// slots (51.9 + 4.7 MB); about 16 float operations per element.
//
// Design: see scatter_window.cuh. The sweep is dense, as the TPU kernel's
// grid is: every tile is read and written whether or not the batch
// touched it. A thread applies FTRL to the (slot, channel) whose run it
// just summed, so the state streams through once with coalesced loads
// and stores.

#include "scatter_window.cuh"

namespace {

using namespace xf_scatter;

struct Ftrl {
  float alpha, beta, lambda1, lambda2;
};

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);  // 0 -> 0, NaN -> NaN
}

__global__ void __launch_bounds__(THREADS)
scatter_ftrl_kernel(const float* __restrict__ d, const int32_t* __restrict__ slots,
                    const int32_t* __restrict__ win_off, const float* __restrict__ w_in,
                    const float* __restrict__ n_in, const float* __restrict__ z_in,
                    float* __restrict__ w_out, float* __restrict__ n_out,
                    float* __restrict__ z_out, int k, long long np, int bf16, Ftrl hp) {
  __shared__ long long run[TILE + 1];
  long long s0 = (long long)blockIdx.x * TILE;
  tile_runs(slots, win_off, s0, run);
  long long base = s0 * k;
  for (int i = threadIdx.x; i < TILE * k; i += blockDim.x) {
    int t = i / k, c = i - t * k;
    float g = run_sum(d, np, c, run[t], run[t + 1], bf16);
    long long e = base + i;
    float w = w_in[e], n = n_in[e], z = z_in[e];
    float n_new = __fadd_rn(n, __fmul_rn(g, g));
    float sq_new = __fsqrt_rn(n_new);
    float step = __fmul_rn(__fdiv_rn(__fsub_rn(sq_new, __fsqrt_rn(n)), hp.alpha), w);
    float z_new = __fsub_rn(__fadd_rn(z, g), step);
    float shrink = __fmul_rn(sign_of(z_new), hp.lambda1);
    float denom = __fadd_rn(__fdiv_rn(__fadd_rn(hp.beta, sq_new), hp.alpha), hp.lambda2);
    float w_new = fabsf(z_new) <= hp.lambda1 ? 0.0f : __fdiv_rn(-__fsub_rn(z_new, shrink), denom);
    if (g == 0.0f && n == 0.0f) w_new = w;
    w_out[e] = w_new;
    n_out[e] = n_new;
    z_out[e] = z_new;
  }
}

}  // namespace

// num_slots must be a multiple of 2048 (the wrapper checks it).
extern "C" int xf_scatter_ftrl(const void* d, const void* slots, const void* win_off,
                               const void* w, const void* n, const void* z, void* w_out,
                               void* n_out, void* z_out, long long num_slots, int k,
                               long long np, int bf16, float alpha, float beta,
                               float lambda1, float lambda2, void* stream) {
  if (num_slots > 0) {
    unsigned blocks = (unsigned)(num_slots / xf_scatter::TILE);
    scatter_ftrl_kernel<<<blocks, xf_scatter::THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)d, (const int32_t*)slots, (const int32_t*)win_off, (const float*)w,
        (const float*)n, (const float*)z, (float*)w_out, (float*)n_out, (float*)z_out, k,
        np, bf16, Ftrl{alpha, beta, lambda1, lambda2});
  }
  return (int)cudaGetLastError();
}
