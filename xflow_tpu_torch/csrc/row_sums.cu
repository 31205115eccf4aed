// Occurrence -> row reduction for Hopper (sm_90a): the forward of
// `row_sums_sorted`, replacing the TPU kernel `_rowsum_pallas`
// (xflow_tpu/ops/sorted_table.py, `_rowsum_kernel_factory`).
//
// Contract:  out[r, c] = vals[c, j1] + vals[c, j2] + ... over the j with
// rows[j] = r, added one by one in ascending j from +0: the TPU kernel's
// order (one sequential grid step, `out[r] += vt[i]` in plan order) and
// the CPU's `index_add_`, so the sums are bitwise those of the plain
// version and bitwise the same from launch to launch. vals float32 [ch,
// Np], rows int32 [Np], out float32 [B, ch]; ch and Np multiples of 4,
// vals and rows 16 B aligned. Rows outside [0, B) are skipped. A position
// whose ch values are all +-0 (pads, masked occurrences) is dropped: a
// sum begun at +0 is never -0, so a +-0 addend never changes it. No float
// atomics, no tree and no FMA touch a sum; the atomics below are integer
// ones, exact in any order.
//
// Bound on the H100: bytes by the roofline, Np * (ch + 1) * 4 B read and
// B * ch * 4 B written (0.0371 ms for the FM headline's ch 24, Np
// 1,180,672, B 65,536). A fixed order costs more bytes than that: the
// positions arrive in slot order, so each row's terms lie scattered over
// the plan and must be brought together before they are added in order.
// Five kernels, about three times the bound's bytes:
//
// 1. count: a thread a position quad reads its rows and its channels
//    until each in-range position shows a nonzero value (most stop at
//    channel 0; an all-zero one reads all ch), writes a byte flag a
//    position and adds 1 to its row's count (integer atomics).
// 2. reserve: each row takes a segment of `pj`, one block's rows at a
//    time (a block scan of the counts, one atomic a block on the running
//    total); rows of more than WMAX terms go on a list.
// 3. place: a block stages a tile of 256 positions, 8 channel quads at a
//    time, transposed in shared memory, and writes each counted
//    position's ch values to its own row of a position-major copy (so the
//    block's stores are contiguous), and its j to a slot of its row's
//    segment of `pj` (slots in any order). Position quads with nothing
//    counted read no values: a fully-sharded buffer's pad run costs its
//    rows and flags only.
// 4. reduce: a warp a row of at most WMAX terms copies the row's entries
//    of the copy into shared memory (async copies, in flight while it
//    ranks the js: a rank is the count of smaller js over the warp's
//    shuffles), then lanes over the channel quads add the entries in rank
//    order from +0.
// 5. long rows (more than WMAX terms), a block a row, on a stream of its
//    own beside the reduce (it takes an SM a row, the reduce every SM).
//    The row's positions set bits in a shared-memory bitmap, window by
//    window of 1,310,720 positions; a position's rank is the count of set
//    bits before it, which orders the row's js; the entries are copied in
//    that order, a chunk at a time, and added by a thread a quad.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;  // reserve: 32 warps, one scan level
constexpr int WMAX = 128;           // longest row a warp orders (four js a lane)
constexpr int TILE = THREADS;       // positions a place block stages, one a thread
constexpr int PQ = TILE / 4;        // position quads a tile
constexpr int NQMAX = 8;            // channel quads a staging pass holds
constexpr int UNITS = PQ * NQMAX / THREADS;  // staging units (4 x 4 floats) a thread
constexpr int RBUF = 256;           // float4 quads a reduce warp stages
constexpr int LONG_THREADS = 1024;
constexpr int WWORDS = 40960;       // a long row's window: 1,310,720 positions, a bit each
constexpr int GROUPS = WWORDS / 32;  // of 32 words, each with its count of set bits before it
constexpr int GROUPS_PER_WARP = GROUPS / (LONG_THREADS / 32);
constexpr int LBUF = 4096;          // entries a staged chunk lists
constexpr size_t LONG_SMEM = (size_t)(WWORDS + GROUPS + LBUF) * 4;  // 181 KB

__device__ __forceinline__ bool in_range(int r, long long num_rows) {
  return r >= 0 && (long long)r < num_rows;
}

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// 16 B from global to shared memory without a register (the async copy)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned nonzero4(const float4 x) {
  return (unsigned)(x.x != 0.0f) | ((unsigned)(x.y != 0.0f) << 1) |
         ((unsigned)(x.z != 0.0f) << 2) | ((unsigned)(x.w != 0.0f) << 3);
}

__global__ void __launch_bounds__(THREADS)
    row_sums_count_kernel(const float* __restrict__ vals, const int32_t* __restrict__ rows,
                          uint8_t* __restrict__ flags, int32_t* __restrict__ cnt, int ch,
                          long long np, long long num_rows) {
  const long long p = 4 * ((long long)blockIdx.x * THREADS + threadIdx.x);
  if (p >= np) return;
  const int4 r4 = __ldg(reinterpret_cast<const int4*>(rows + p));
  const float4* v = reinterpret_cast<const float4*>(vals + p);
  unsigned nz = nonzero4(__ldg(v));  // channel 0, loaded beside the rows
  const int r[4] = {r4.x, r4.y, r4.z, r4.w};
  unsigned todo = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) todo |= (unsigned)in_range(r[k], num_rows) << k;
  for (int c = 1; c < ch && (nz & todo) != todo; ++c) nz |= nonzero4(__ldg(v + c * (np / 4)));
  nz &= todo;
  *reinterpret_cast<uchar4*>(flags + p) =
      make_uchar4(nz & 1, (nz >> 1) & 1, (nz >> 2) & 1, (nz >> 3) & 1);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if ((nz >> k) & 1) atomicAdd(cnt + r[k], 1);
}

// totals[0]: entries reserved so far, totals[1]: rows listed as long.
// Leaves cnt at 0 for `place` to count slots with.
__global__ void __launch_bounds__(SCAN_THREADS)
    row_sums_reserve_kernel(int32_t* __restrict__ cnt, int32_t* __restrict__ off,
                            int32_t* __restrict__ long_rows, int32_t* __restrict__ totals,
                            long long num_rows) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  __shared__ int base;
  const long long r = (long long)blockIdx.x * SCAN_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = r < num_rows ? cnt[r] : 0;
  int x = n;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int s = warp_sums[lane];
    int t = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += y;
    }
    warp_sums[lane] = t - s;
    if (lane == 31) base = atomicAdd(totals, t);
  }
  __syncthreads();
  if (r < num_rows) {
    off[r] = base + warp_sums[warp] + x - n;
    cnt[r] = 0;
    if (n > WMAX) long_rows[atomicAdd(totals + 1, 1)] = (int)r;
  }
}

// Slot of quad qq in row t of a staging slab with nq quads a row: the
// rotation spreads the transposed 16 B stores over the banks.
__device__ __forceinline__ int quad_slot(int qq, int t, int nq) {
  int s = qq + ((t >> 2) & 7);
  while (s >= nq) s -= nq;
  return s;
}

__global__ void __launch_bounds__(THREADS)
    row_sums_place_kernel(const float* __restrict__ vals, const int32_t* __restrict__ rows,
                          const uint8_t* __restrict__ flags, const int32_t* __restrict__ off,
                          int32_t* __restrict__ cnt, int32_t* __restrict__ pj,
                          float* __restrict__ copy, int ch, long long np) {
  __shared__ float4 slab[TILE * NQMAX];
  __shared__ __align__(4) uint8_t flag[TILE];
  const long long j0 = (long long)blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const long long j = j0 + tid;
  const bool mine = j < np && flags[j];
  flag[tid] = mine;
  int s = -1;
  if (mine) {  // the slot: its value is first needed after the first staging loads
    const int r = rows[j];
    s = off[r] + atomicAdd(cnt + r, 1);
  }
  if (!__syncthreads_or(mine)) return;
  const int quads = ch / 4;
  for (int q0 = 0; q0 < quads; q0 += NQMAX) {
    const int nq = min(NQMAX, quads - q0);
    // unit k: channels 4 (q0 + qq) .. + 3 at positions 4 pq .. + 3, loaded
    // when one of the four is counted
    float4 reg[UNITS][4];
    bool live[UNITS];
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = tid + k * THREADS, pq = u % PQ, qq = u / PQ;
      live[k] = qq < nq && reinterpret_cast<const uint32_t*>(flag)[pq] != 0;
      if (live[k]) {
        const float4* src =
            reinterpret_cast<const float4*>(vals + 4LL * (q0 + qq) * np + j0) + pq;
#pragma unroll
        for (int i = 0; i < 4; ++i) reg[k][i] = __ldg(src + i * (np / 4));
      }
    }
    if (q0 == 0) {
      if (mine) pj[s] = (int)j;
    } else {
      __syncthreads();  // the previous pass's stores have read the slab
    }
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = tid + k * THREADS, pq = u % PQ, qq = u / PQ;
      if (live[k]) {
        float4* dst = slab + 4 * pq * nq + quad_slot(qq, 4 * pq, nq);
        dst[0] = make_float4(reg[k][0].x, reg[k][1].x, reg[k][2].x, reg[k][3].x);
        dst[nq] = make_float4(reg[k][0].y, reg[k][1].y, reg[k][2].y, reg[k][3].y);
        dst[2 * nq] = make_float4(reg[k][0].z, reg[k][1].z, reg[k][2].z, reg[k][3].z);
        dst[3 * nq] = make_float4(reg[k][0].w, reg[k][1].w, reg[k][2].w, reg[k][3].w);
      }
    }
    __syncthreads();
    // thread tid takes (position t, quad qq) = divmod(tid + k THREADS, nq),
    // quads fastest: a position's row of the copy is written contiguously
    int t = tid / nq, qq = tid - t * nq;
    const int dt = THREADS / nq, dq = THREADS - dt * nq;
    for (int idx = tid; idx < TILE * nq; idx += THREADS) {
      if (flag[t])
        *reinterpret_cast<float4*>(copy + (j0 + t) * ch + 4 * (q0 + qq)) =
            slab[t * nq + quad_slot(qq, t, nq)];
      t += dt;
      qq += dq;
      if (qq >= nq) {
        qq -= nq;
        ++t;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    row_sums_reduce_kernel(const float* __restrict__ copy, const int32_t* __restrict__ pj,
                           const int32_t* __restrict__ off, const int32_t* __restrict__ cnt,
                           float* __restrict__ out, int ch, long long num_rows) {
  __shared__ int jbuf[WARPS][WMAX];
  __shared__ int order[WARPS][WMAX];
  __shared__ float4 buf[WARPS][RBUF];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * WARPS + warp;
  if (r >= num_rows) return;
  const int n = cnt[r], base = off[r];
  if (n > WMAX) return;  // the long-row kernel's
  const int nq = ch / 4;
  float4* dst = reinterpret_cast<float4*>(out) + r * nq;
  if (n == 0) {
    for (int q = lane; q < nq; q += 32) dst[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  // the row's positions, in slot order
  int* js = jbuf[warp];
  int j[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = 32 * m + lane;
    j[m] = i < n ? pj[base + i] : INT_MAX;
    if (i < n) js[i] = j[m];
  }
  __syncwarp();
  // their channels copied, a slice of qs quads at a time, (entry, quad)
  // with quads fastest; the first slice's copies fly while the js are ranked
  const float4* copy4 = reinterpret_cast<const float4*>(copy);
  float4* b = buf[warp];
  const int qs_max = min(nq, RBUF / n);
  auto fetch = [&](int q0, int qs) {
    int e = lane / qs, q = lane - e * qs;
    const int de = 32 / qs, dq = 32 - de * qs;
    for (int u = lane; u < n * qs; u += 32) {
      cp_async16(b + u, copy4 + (long long)js[e] * nq + q0 + q);
      e += de;
      q += dq;
      if (q >= qs) {
        q -= qs;
        ++e;
      }
    }
    cp_async_commit();
  };
  fetch(0, qs_max);
  // rank them by j: a rank is the count of smaller js
  int* ord = order[warp];
  if (n <= 32) {
    int rank = 0;
    for (int src = 0; src < n; ++src) rank += __shfl_sync(0xffffffffu, j[0], src) < j[0];
    if (lane < n) ord[rank] = lane;
  } else {  // lane l holds entries l, l + 32, ...
    const int nreg = (n + 31) >> 5;
    int rank[4] = {0, 0, 0, 0};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m >= nreg) break;
      for (int src = 0; src < 32; ++src) {
        const int x = __shfl_sync(0xffffffffu, j[m], src);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) rank[mm] += x < j[mm];
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = 32 * m + lane;
      if (i < n) ord[rank[m]] = i;
    }
  }
  // each quad's terms added in rank order from +0
  for (int q0 = 0; q0 < nq; q0 += qs_max) {
    const int qs = min(qs_max, nq - q0);
    if (q0 > 0) {
      __syncwarp();  // the previous slice has been read
      fetch(q0, qs);
    }
    cp_async_wait_all();
    __syncwarp();
    for (int q = lane; q < qs; q += 32) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int k = 0;
      for (; k + 4 <= n; k += 4) {
        float4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = b[ord[k + i] * qs + q];
#pragma unroll
        for (int i = 0; i < 4; ++i) add4(acc, v[i]);
      }
      for (; k < n; ++k) add4(acc, b[ord[k] * qs + q]);
      dst[q0 + q] = acc;
    }
  }
}

// A row of more than WMAX terms, a block each. Its positions, window by
// window of WWORDS * 32, set bits in a shared-memory bitmap; a position's
// rank in ascending j is the count of set bits before it (a count a group
// of 32 words, then the words of its group), and `order[base + rank]`
// takes its entry. Then the entries in that order, a chunk at a time,
// are copied into the bitmap's memory and each quad's thread adds them
// in order; the sum rides in `out` from one chunk and window to the next.
__global__ void __launch_bounds__(LONG_THREADS)
    row_sums_long_kernel(const float* __restrict__ copy, const int32_t* __restrict__ pj,
                         const int32_t* __restrict__ off, const int32_t* __restrict__ cnt,
                         const int32_t* __restrict__ long_rows, const int32_t* __restrict__ totals,
                         int32_t* __restrict__ order, float* __restrict__ out, int ch) {
  extern __shared__ __align__(16) uint32_t lsm[];
  uint32_t* bits = lsm;
  int* gp = reinterpret_cast<int*>(lsm + WWORDS);
  int* list = gp + GROUPS;
  float4* stg = reinterpret_cast<float4*>(lsm);  // the bitmap, once ranked
  __shared__ int warp_sums[LONG_THREADS / 32];
  __shared__ int s_next;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_long = totals[1];
  const int nq = ch / 4;
  const float4* copy4 = reinterpret_cast<const float4*>(copy);
  auto block_min = [&](int v) {  // into s_next, which holds INT_MAX
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, d));
    if (lane == 0) atomicMin(&s_next, v);
  };
  for (int li = blockIdx.x; li < n_long; li += gridDim.x) {
    const int r = long_rows[li];
    const int n = cnt[r], base = off[r];
    float4* row = reinterpret_cast<float4*>(out) + (long long)r * nq;
    for (int q = tid; q < nq; q += LONG_THREADS) row[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    if (tid == 0) s_next = INT_MAX;
    __syncthreads();
    int mn = INT_MAX;
    for (int e = tid; e < n; e += LONG_THREADS) mn = min(mn, pj[base + e]);
    block_min(mn);
    __syncthreads();
    long long lo = s_next;
    int done = 0;  // entries of earlier windows
    while (true) {
      const long long hi = lo + 32LL * WWORDS;
      for (int w = tid; w < WWORDS; w += LONG_THREADS) bits[w] = 0;
      __syncthreads();
      if (tid == 0) s_next = INT_MAX;
      __syncthreads();
      int nx = INT_MAX;
      for (int e = tid; e < n; e += LONG_THREADS) {
        const int j = pj[base + e];
        if (j >= lo && j < hi)
          atomicOr(bits + ((j - lo) >> 5), 1u << ((j - lo) & 31));
        else if (j >= hi)
          nx = min(nx, j);
      }
      block_min(nx);
      __syncthreads();
      // each group's set bits: warp w sums groups w * GROUPS_PER_WARP ..
      int run = 0;
      for (int i = 0; i < GROUPS_PER_WARP; ++i) {
        const int g = warp * GROUPS_PER_WARP + i;
        int c = __popc(bits[g * 32 + lane]);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(0xffffffffu, c, d);
        if (lane == 0) gp[g] = run;
        run += c;
      }
      if (lane == 0) warp_sums[warp] = run;
      __syncthreads();
      int wbase = 0, m = 0;
      for (int w = 0; w < LONG_THREADS / 32; ++w) {
        wbase += w < warp ? warp_sums[w] : 0;
        m += warp_sums[w];
      }
      for (int i = lane; i < GROUPS_PER_WARP; i += 32) gp[warp * GROUPS_PER_WARP + i] += wbase;
      __syncthreads();
      for (int e = tid; e < n; e += LONG_THREADS) {
        const int j = pj[base + e];
        if (j < lo || j >= hi) continue;
        const int d = (int)(j - lo), w = d >> 5, g = w >> 5;
        int rank = gp[g] + __popc(bits[w] & ((1u << (d & 31)) - 1));
        for (int w2 = g * 32; w2 < w; ++w2) rank += __popc(bits[w2]);
        order[base + done + rank] = j;
      }
      __syncthreads();
      // add the window's m entries in rank order: a slice of up to
      // LONG_THREADS quads, a chunk of kn entries at a time
      for (int q0 = 0; q0 < nq; q0 += LONG_THREADS) {
        const int qs = min(LONG_THREADS, nq - q0);
        const int per = min(LBUF, WWORDS / 4 / qs);
        float4 acc = tid < qs ? row[q0 + tid] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int k0 = 0; k0 < m; k0 += per) {
          const int kn = min(per, m - k0);
          for (int k = tid; k < kn; k += LONG_THREADS) list[k] = order[base + done + k0 + k];
          __syncthreads();
          for (int u = tid; u < kn * qs; u += LONG_THREADS) {
            const int k = u / qs, q = u - k * qs;
            cp_async16(stg + u, copy4 + (long long)list[k] * nq + q0 + q);
          }
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
          if (tid < qs) {
            int k = 0;
            for (; k + 8 <= kn; k += 8) {
              float4 v[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) v[i] = stg[(k + i) * qs + tid];
#pragma unroll
              for (int i = 0; i < 8; ++i) add4(acc, v[i]);
            }
            for (; k < kn; ++k) add4(acc, stg[k * qs + tid]);
          }
          __syncthreads();
        }
        if (tid < qs) row[q0 + tid] = acc;
      }
      done += m;
      if (s_next == INT_MAX) break;  // reset only after the next window's first barrier
      lo = s_next;
    }
    __syncthreads();
  }
}

// The long-row kernel runs on a stream of its own beside the reduce
// kernel (it takes one SM a row; the reduce, every SM): `side` waits for
// `placed`, recorded on the caller's stream after the place kernel, and
// the caller's stream waits for `done` before anything after this call.
// One mutex orders the recording and waiting of concurrent callers.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t placed = nullptr, done = nullptr;
  int sms = 0;
};
std::mutex side_mutex;
Side sides[64];

// The device's side stream and events, made at its first call (the long
// kernel's shared-memory limit set then too), under `side_mutex`.
cudaError_t side_of(int dev, Side** out) {
  Side& side = sides[dev];
  *out = &side;
  if (side.stream != nullptr) return cudaSuccess;
  int least = 0, greatest = 0;  // the side stream's blocks go first when both are ready
  cudaError_t err = cudaDeviceGetAttribute(&side.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(row_sums_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)LONG_SMEM);
  if (err == cudaSuccess) err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
  if (err == cudaSuccess) err = cudaEventCreateWithFlags(&side.placed, cudaEventDisableTiming);
  if (err == cudaSuccess) err = cudaEventCreateWithFlags(&side.done, cudaEventDisableTiming);
  if (err == cudaSuccess)
    err = cudaStreamCreateWithPriority(&side.stream, cudaStreamNonBlocking, greatest);
  return err;
}

}  // namespace

// ws: int32 [2 + 3 * num_rows]: totals[2], counts, offsets, the long rows
// (the first 2 + num_rows are zeroed here); flags uint8 [np]; pj and
// order int32 [np]; copy float32 [np * ch].
extern "C" int xf_row_sums(const void* vals, const void* rows, void* out, int ch,
                           long long np, long long num_rows, void* ws, void* flags, void* pj,
                           void* order, void* copy, void* stream) {
  if (num_rows <= 0 || ch <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* totals = (int32_t*)ws;
  int32_t* cnt = totals + 2;
  int32_t* off = cnt + num_rows;
  int32_t* long_rows = off + num_rows;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= 64)) err = cudaErrorInvalidDevice;
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(side_mutex);
  Side* side = nullptr;
  err = side_of(dev, &side);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(totals, 0, (2 + num_rows) * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (np > 0) {
    row_sums_count_kernel<<<(unsigned)((np / 4 + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        (const float*)vals, (const int32_t*)rows, (uint8_t*)flags, cnt, ch, np, num_rows);
  }
  row_sums_reserve_kernel<<<(unsigned)((num_rows + SCAN_THREADS - 1) / SCAN_THREADS),
                            SCAN_THREADS, 0, s>>>(cnt, off, long_rows, totals, num_rows);
  if (np > 0) {
    row_sums_place_kernel<<<(unsigned)((np + TILE - 1) / TILE), THREADS, 0, s>>>(
        (const float*)vals, (const int32_t*)rows, (const uint8_t*)flags, off, cnt, (int32_t*)pj,
        (float*)copy, ch, np);
  }
  err = cudaEventRecord(side->placed, s);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(side->stream, side->placed, 0);
  if (err != cudaSuccess) return (int)err;
  row_sums_long_kernel<<<(unsigned)side->sms, LONG_THREADS, LONG_SMEM, side->stream>>>(
      (const float*)copy, (const int32_t*)pj, off, cnt, long_rows, totals, (int32_t*)order,
      (float*)out, ch);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventRecord(side->done, side->stream);
  if (err != cudaSuccess) return (int)err;
  row_sums_reduce_kernel<<<(unsigned)((num_rows + WARPS - 1) / WARPS), THREADS, 0, s>>>(
      (const float*)copy, (const int32_t*)pj, off, cnt, (float*)out, ch, num_rows);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamWaitEvent(s, side->done, 0);
  return (int)err;
}
