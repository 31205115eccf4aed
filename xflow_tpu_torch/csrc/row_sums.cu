// Occurrence -> row reduction for Hopper (sm_90a): the forward of
// `row_sums_sorted`, replacing the TPU kernel `_rowsum_pallas`
// (xflow_tpu/ops/sorted_table.py, `_rowsum_kernel_factory`).
//
// Contract:  out[r, c] += vals[c, j]  for every j with rows[j] = r
// vals float32 [ch, Np], rows int32 [Np], out float32 [B, ch], zeroed by
// the caller; ch and Np multiples of 4, vals, rows and out 16 B aligned.
// Rows outside [0, B) are skipped. Pads carry row 0 and value 0 by the
// plan contract, so they add nothing.
//
// Bound on the H100: bytes by the roofline, Np * (ch + 1) * 4 B read and
// B * ch * 4 B written (0.0371 ms for the FM headline's ch 24, Np
// 1,180,672, B 65,536). What holds it in practice is the L2's rate of
// reductions: the occurrences arrive in slot order, so their rows are
// scattered over [0, B) and every value is a read-modify-write of an
// output in L2, one per 16 B at best. This kernel spends that rate once
// per four channels:
//
// - Vector reductions: one `red.global.add.v4.f32` (PTX ISA 8.1, sm_90)
//   adds an occurrence's four channels into its 16 B aligned output
//   quad, a quarter of the atomic instructions of one `atomicAdd` a
//   value. A quad of four zeros (masked occurrences, pads, FM's padding
//   channels) is skipped: adding +0 never changes a sum.
// - Channel-group items: the work is a stream of (tile of TILE
//   positions, group of at most 32 channels) items, the channels split
//   into groups of whole quads as evenly as they go (ch 136: 7, 7, 7, 7
//   and 6 quads). A block's shared memory is two [TILE][group] slabs
//   whatever ch is: no channel limit, no opt-in cliff at wide channels.
//   The items run group by group (all tiles of group 0, then group 1),
//   so the outputs under reduction at any time are B x 32 floats of
//   one group, which stay in L2 where a tile-major order would sweep all
//   of [B, ch] (measured faster at ch 104-136, equal at ch <= 32).
// - Transposed staging: a thread loads four channels of four positions
//   (four 16 B loads, coalesced along the positions across a warp) and
//   stores them transposed, so an occurrence's quad is one 16 B
//   shared-memory read. Quad qq of row t sits at slot (qq + t/4 % 8) mod
//   nq of its row: the rotation spreads the transposed 16 B stores over
//   the banks (without it the eight lanes of a store phase hit one bank
//   group).
// - Persistent blocks: the occupancy's worth of blocks a SM, each walking
//   items gridDim apart. A block issues the loads of its next item into
//   registers, then reduces this item from shared memory while they are
//   in flight, and stores them after: the staging hides behind the
//   reductions, with one barrier an item (two slabs alternate).
//
// Float reductions add in whatever order the blocks reach an address, so
// the last bits of a sum can differ from run to run (tolerance: 1e-4
// relative over a 1e-2 floor on the main paths' data, the float32
// reorder bound on many-term rows). A deterministic form (a row-ordered
// permutation from the plan, read segment by segment) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;                      // positions an item
constexpr int THREADS = 256;
constexpr int NQMAX = 8;                       // quads (4 channels) a group at most
constexpr int PQ = TILE / 4;                   // position quads a tile
constexpr int UNITS = PQ * NQMAX / THREADS;    // staging units (4 channels x 4 positions) a thread
static_assert(PQ * NQMAX % THREADS == 0, "staging units divide over the threads");

__device__ __forceinline__ void red_add_v4(float* dst, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Slot of quad qq in row t of a slab with nq quads a row.
__device__ __forceinline__ int quad_slot(int qq, int t, int nq) {
  int s = qq + ((t >> 2) & 7);
  while (s >= nq) s -= nq;
  return s;
}

struct Groups {
  int n, base, rem;  // n groups: the first rem of base + 1 quads, the rest of base
  __device__ __forceinline__ int nq(int g) const { return base + (g < rem); }
  __device__ __forceinline__ int q0(int g) const { return g * base + (g < rem ? g : rem); }
};

__global__ void __launch_bounds__(THREADS)
    row_sums_kernel(const float* __restrict__ vals, const int32_t* __restrict__ rows,
                    float* __restrict__ out, int ch, long long np, long long num_rows,
                    Groups groups, long long n_tiles, int nq_max) {
  extern __shared__ float4 smem[];  // two [TILE][nq_max] quad slabs, then two [TILE] rows
  int32_t* rows_smem = reinterpret_cast<int32_t*>(smem + 2 * TILE * nq_max);
  const long long n_items = n_tiles * groups.n;
  const int tid = threadIdx.x;
  float4 reg[UNITS][4];  // unit k: channels 4 (q0 + qq) .. + 3 at positions p .. p + 3
  int4 rreg = make_int4(-1, -1, -1, -1);

  // issue the loads of `item` into registers
  auto load = [&](long long item) {
    const int g = (int)(item / n_tiles);
    const long long j0 = (item % n_tiles) * TILE;
    const int nq = groups.nq(g), q0 = groups.q0(g);
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = tid + k * THREADS, pq = u % PQ, qq = u / PQ;
      const long long p = j0 + 4 * pq;
      if (qq < nq && p < np) {
        const float4* src = reinterpret_cast<const float4*>(vals + 4LL * (q0 + qq) * np + p);
#pragma unroll
        for (int i = 0; i < 4; ++i) reg[k][i] = __ldg(src + i * (np / 4));
      }
    }
    if (tid < PQ) {
      const long long p = j0 + 4 * tid;
      rreg = p < np ? __ldg(reinterpret_cast<const int4*>(rows + p)) : make_int4(-1, -1, -1, -1);
    }
  };

  long long item = blockIdx.x;
  if (item >= n_items) return;
  load(item);
  for (int buf = 0; item < n_items; item += gridDim.x, buf ^= 1) {
    const int g = (int)(item / n_tiles);
    const int nq = groups.nq(g), q0 = groups.q0(g);
    float4* slab = smem + buf * TILE * nq_max;
    int32_t* rows_t = rows_smem + buf * TILE;
    // the registers, transposed: row t = 4 pq + e. Positions past Np
    // were not loaded; their rows are -1, so they are never read.
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = tid + k * THREADS, pq = u % PQ, qq = u / PQ;
      if (qq < nq) {
        float4* dst = slab + 4 * pq * nq + quad_slot(qq, 4 * pq, nq);
        dst[0] = make_float4(reg[k][0].x, reg[k][1].x, reg[k][2].x, reg[k][3].x);
        dst[nq] = make_float4(reg[k][0].y, reg[k][1].y, reg[k][2].y, reg[k][3].y);
        dst[2 * nq] = make_float4(reg[k][0].z, reg[k][1].z, reg[k][2].z, reg[k][3].z);
        dst[3 * nq] = make_float4(reg[k][0].w, reg[k][1].w, reg[k][2].w, reg[k][3].w);
      }
    }
    if (tid < PQ) reinterpret_cast<int4*>(rows_t)[tid] = rreg;
    __syncthreads();
    if (item + gridDim.x < n_items) load(item + gridDim.x);
    // reduce: thread idx takes (row t, quad qq), quads fastest
    int t = tid / nq, qq = tid - t * nq;
    const int dt = THREADS / nq, dq = THREADS - dt * nq;
    for (int idx = tid; idx < TILE * nq; idx += THREADS) {
      const int r = rows_t[t];
      const float4 v = slab[t * nq + quad_slot(qq, t, nq)];
      if (r >= 0 && (long long)r < num_rows &&
          (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f))
        red_add_v4(out + (long long)r * ch + 4 * (q0 + qq), v);
      t += dt;
      qq += dq;
      if (qq >= nq) {
        qq -= nq;
        ++t;
      }
    }
  }
}

}  // namespace

extern "C" int xf_row_sums(const void* vals, const void* rows, void* out, int ch,
                           long long np, long long num_rows, void* stream) {
  if (np <= 0 || ch <= 0) return (int)cudaGetLastError();
  const int quads = ch / 4;
  Groups groups;
  groups.n = (quads + NQMAX - 1) / NQMAX;
  groups.base = quads / groups.n;
  groups.rem = quads % groups.n;
  const int nq_max = groups.base + (groups.rem > 0);
  const long long n_tiles = (np + TILE - 1) / TILE;
  const size_t smem = 2 * ((size_t)TILE * nq_max * sizeof(float4) + TILE * sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(row_sums_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_sums_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > n_tiles * groups.n) grid = n_tiles * groups.n;
  row_sums_kernel<<<(unsigned)grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)vals, (const int32_t*)rows, (float*)out, ch, np, num_rows, groups, n_tiles,
      nq_max);
  return (int)cudaGetLastError();
}
