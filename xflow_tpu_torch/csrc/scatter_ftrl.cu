// Fused windowed scatter-add + FTRL-proximal update for Hopper (sm_90a),
// kernel #3, replacing the TPU kernel `_scatter_ftrl_pallas`
// (xflow_tpu/ops/sorted_table.py, `_scatter_ftrl_kernel` -> `_scatter_span`
// + xflow_tpu/optim/ftrl.py `_update_one`).
//
// Contract (the same as `scatter_ftrl_sorted`'s CPU composition, the
// scatter of scatter_sorted.cu followed by the FTRL update on every slot):
//   g[s, c] = sum over plan positions j with slots[j] = s of d[c, j]
//   (w', n', z')[s, c] = ftrl(w, n, z, g)[s, c]   for every s < S, c < K
// in one launch: g is summed in shared memory and never written to device
// memory. w, n, z are float32 [S, K] inputs and w', n', z' fresh float32
// [S, K] outputs (not in place: the step's non-finite guard may keep the
// pre-step state). Hyperparameters alpha, beta, lambda1, lambda2. Slots
// outside [0, S) are dropped; pads carry d = 0 and add 0; with bf16 != 0
// each term is rounded to bfloat16 before the float32 add. With a counter
// given, the number of non-finite w', n' and z' entries is added into it.
//
// FTRL arithmetic is `optim/ftrl.py::update_one` op for op with IEEE
// float32 operations (__f*_rn: no contraction into FMAs, correctly
// rounded sqrt and division), sign(0) = 0, and the lazy-init guard: a
// slot with g == 0 and old n == 0 keeps its w bitwise.
//
// The sums need not follow plan order, but they are deterministic: each
// (slot, channel) sum is a fixed tree over its terms that depends on the
// plan alone (never on the grid, the SM count or timing), so two launches
// give the same bits.
//
// Bound on the H100: bytes. w, n, z are read and w', n', z' written once
// (6 * S * K floats, 1,107 MB at S = 2^22, K = 11), plus d[:K] and the
// slots (51.9 + 4.7 MB); about 16 float operations per element.
//
// Design. The state is cut into tiles of TILE consecutive slots (512 at
// K = 10 and 11, 64 at K = 73: a tile's w, n and z within 72 KB), so a
// tile is TILE * K floats that start 16 B aligned (TILE a multiple of 4).
// A persistent grid of one block a SM runs one producer warp and sixteen
// consumer warps (the block's 227 KB of shared memory holds two tiles'
// state; half the tile and two blocks a SM measured slower: each tile pays
// its search, barriers and FTRL epilogue once).
//   1. Stream the state: the producer's lane 0 brings each tile's w, n and
//      z into a ring of two stages by TMA bulk copies (`cp.async.bulk`,
//      an mbarrier a stage, an L2 evict-first policy), so the next tile's
//      loads are in flight while the consumers run FTRL on this one; w',
//      n', z' leave by 16 B streaming stores from registers.
//   2. Locate spans without a search a slot: the producer takes four
//      consecutive tiles at a time (one window's) from a counter and finds
//      their five boundaries together, a 32-ary search each inside the
//      plan's window span (win_off): one load latency a level for all five,
//      two or three levels. It stages each tile's span, from its 16 B
//      aligned start, in chunks of CH positions (512 at K = 11, 128 at K =
//      73): the slots' row and d's K rows by one TMA bulk copy a row
//      (coalesced along the rows of the channel-major d) into a ring of two
//      chunk buffers.
//   3. Split runs into pieces, in parallel: positions are cut into pieces
//      of 32 on a grid that depends on the plan alone. A consumer warp takes
//      a piece (a lane a position) and 4 channels (8 at K >= 32), finds its
//      runs by comparing neighbours (a ballot), and sums each run's part by
//      a segmented shuffle scan, a fixed tree (levels longer than the
//      longest run are skipped). A run inside one piece goes to the tile's
//      sums at once; the parts of a run that crosses pieces go to a table
//      and one more segmented scan joins them in piece order. A chunk that
//      is one run (a hot slot's middle) is summed a lane every 32nd position
//      in order, then a butterfly. A run longer than a chunk (the hot-slot
//      plan's 65,536 occurrences) is streamed through the chunk ring, its
//      chunks' parts added in chunk order. No run is summed by one thread.
//   4. The epilogue counts non-finite w', n', z' per thread, reduces the
//      count in the warp and then the block, and adds it to the counter
//      with one integer atomicAdd a block (exact in any order).
//   5. Tiles are taken from a counter, so the block holding a long span
//      takes fewer of the others: the hot-slot plan costs about what a
//      uniform one does.
// FTRL skips work whose result is already known, bit for bit (see
// `ftrl_one`).
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W: 0.4279
// ms at the FM headline's inputs (81% of the bound), 0.4101 on the MVM
// product's (77%), 3.2252 at FFM's K = 73 (74%), 0.4328 on the hot-slot
// plan. What sets the time is the consumers' work a tile (the run sums,
// then FTRL), not the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long WINDOW = 2048;            // slots a window of the plan's win_off
constexpr int CWARPS = 16;                    // consumer warps
constexpr int CONSUMERS = CWARPS * 32;
constexpr int THREADS = CONSUMERS + 32;       // and the producer warp
constexpr int MAX_TILE = 512;                 // slots a tile
constexpr int MIN_CH = 32, MAX_CH = 512;      // positions a chunk (a multiple of 32)
constexpr long long STATE_BYTES = 72 * 1024;  // one stage: a tile's w, n and z
constexpr long long SMEM_TARGET = 220 * 1024; // of the 227 KB a block may take
constexpr int GROUP = 4;                      // tiles the producer takes at once
constexpr int WIDE_K = 32;                    // from here a scan task carries 8 channels
constexpr int MAX_K = 512;
constexpr long long WAIT_CYCLES = 4000000000LL;  // about 2 s: a lost copy traps
constexpr unsigned FULL = 0xffffffffu;
constexpr int KEY_NONE = 0x7fffffff;          // the key of a position not staged

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed; trap
// after WAIT_CYCLES, so a copy that never lands fails the launch.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_CYCLES) __trap();
  }
}

// An L2 policy that evicts these lines first: the state and d stream
// through once, so the slots and window offsets the searches read stay.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// TMA: `bytes` (a multiple of 16) from global to shared memory, completed
// on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

struct Ftrl {
  float alpha, beta, lambda1, lambda2;
};

// The consumer warps only (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// A tile handed from the producer to the consumers: its index (-1: the
// block's stream has ended) and its span, staged from plan position base
// (a multiple of 32: the pieces' grid) over len positions, of which the
// first `lead` are not loaded (the span's 16 B aligned start is base +
// lead).
struct TileInfo {
  long long tile;
  int base, lead, len;
};

// Tile and chunk sizes for K channels: the widest tile whose w, n, z fit
// STATE_BYTES and whose block fits SMEM_TARGET, then the widest chunk that
// keeps it there. Shared memory: two state stages [3][TILE * K], two chunk
// buffers [1 + K][CH] (the slots' row, then d's rows), the tile's sums
// [TILE * K], the pieces' run parts [K][ENT] and keys [ENT] (ENT = 2 CH /
// 32: a piece's first and last run).
struct Geometry {
  int tile, ch, ent;
  long long smem;
};

__host__ __device__ inline long long smem_bytes(int k, int tile, int ch) {
  const long long tk = (long long)tile * k, ent = ch / 16;
  return 4 * (6 * tk + 2LL * (1 + k) * ch + tk + (long long)k * ent + ent);
}

__host__ __device__ inline Geometry geometry(int k) {
  Geometry g;
  int t = MAX_TILE;
  while (t > 4 && (12LL * t * k > STATE_BYTES || smem_bytes(k, t, MIN_CH) > SMEM_TARGET)) t >>= 1;
  int ch = MAX_CH;
  while (ch > MIN_CH && smem_bytes(k, t, ch) > SMEM_TARGET) ch -= 32;
  g.tile = t;
  g.ch = ch;
  g.ent = ch / 16;
  g.smem = smem_bytes(k, t, ch);
  return g;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);  // 0 -> 0, NaN -> NaN
}

__device__ __forceinline__ int nonfinite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

// One element of FTRL; counts the non-finite outputs into `bad`. The
// update_one expression, with the work whose result is already known
// skipped, bit for bit: sqrt(n') is sqrt(n) where n' is n (g^2 under an
// ulp of n, the common case), 0 / alpha is `zero_frac`, and w' needs no
// division where the lazy-init guard keeps w or |z'| <= lambda1.
__device__ __forceinline__ void ftrl_one(float w, float n, float z, float g, const Ftrl& hp,
                                         float zero_frac, float& w_o, float& n_o, float& z_o,
                                         int& bad) {
  const float n_new = __fadd_rn(n, __fmul_rn(g, g));
  const float sq_old = n == 0.0f ? n : __fsqrt_rn(n);
  const float sq_new = __float_as_uint(n_new) == __float_as_uint(n) ? sq_old : __fsqrt_rn(n_new);
  const float num = __fsub_rn(sq_new, sq_old);
  const float frac = __float_as_uint(num) == 0u ? zero_frac : __fdiv_rn(num, hp.alpha);
  const float z_new = __fsub_rn(__fadd_rn(z, g), __fmul_rn(frac, w));
  float w_new;
  if (g == 0.0f && n == 0.0f) {
    w_new = w;
  } else if (fabsf(z_new) <= hp.lambda1) {
    w_new = 0.0f;
  } else {
    const float shrink = __fmul_rn(sign_of(z_new), hp.lambda1);
    const float denom = __fadd_rn(__fdiv_rn(__fadd_rn(hp.beta, sq_new), hp.alpha), hp.lambda2);
    w_new = __fdiv_rn(-__fsub_rn(z_new, shrink), denom);
  }
  w_o = w_new;
  n_o = n_new;
  z_o = z_new;
  bad += nonfinite(w_new) + nonfinite(n_new) + nonfinite(z_new);
}

// A 32-position piece's runs, lane = position: its slot (KEY_NONE past
// the chunk's end), the lane its run starts at, and whether its run ends
// at this lane (inside the piece).
struct Runs {
  int key, start, longest;  // longest: the piece's longest run, in lanes
  bool last, single;        // single: the whole piece is one run
};

__device__ __forceinline__ Runs piece_runs(int key, int lane) {
  const int prev = __shfl_up_sync(FULL, key, 1);
  const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != key);
  Runs r;
  r.key = key;
  r.start = 31 - __clz(heads & (FULL >> (31 - lane)));
  r.last = lane == 31 || ((heads >> (lane + 1)) & 1u);
  r.longest = __reduce_max_sync(FULL, lane - r.start + 1);
  r.single = heads == 1u;
  return r;
}

// Inclusive scans of CG channels' values v over the lanes of each run
// (lanes start..lane): a fixed tree over the run's terms, the channels'
// shuffles interleaved. A level at offset o >= the longest run adds
// nothing to any lane, so it is not run.
template <int CG>
__device__ __forceinline__ void run_scan(float (&v)[CG], int lane, int start, int longest) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o >= longest) break;
    float u[CG];
#pragma unroll
    for (int c = 0; c < CG; ++c) u[c] = __shfl_up_sync(FULL, v[c], o);
    if (lane - o >= start) {
#pragma unroll
      for (int c = 0; c < CG; ++c) v[c] = __fadd_rn(v[c], u[c]);
    }
  }
}

// The producer warp: the spans of tiles t0 .. t0 + G - 1 (one window's),
// bound[u] = the first plan position whose slot is >= (t0 + u) * tile,
// u = 0 .. G, each found by a 32-ary search inside the window's span
// win_off[w] .. win_off[w + 1]; the G + 1 searches run together, so a
// level costs one load latency for all of them. Every lane returns all.
template <int G>
__device__ __forceinline__ void group_bounds(const int32_t* __restrict__ slots,
                                             const int32_t* __restrict__ win_off, int np,
                                             int s0, int tile, int lane, int (&bound)[G + 1]) {
  const int w = s0 / (int)WINDOW;
  int lo = __ldg(win_off + w), hi = __ldg(win_off + w + 1);
  lo = lo < 0 ? 0 : (lo > np ? np : lo);
  hi = hi < lo ? lo : (hi > np ? np : hi);
  int L[G + 1], H[G + 1];  // key u's answer lies in [L[u], H[u]]
#pragma unroll
  for (int u = 0; u <= G; ++u) {
    L[u] = lo;
    H[u] = hi;
  }
  for (bool first = true;; first = false) {
    int32_t probe[G + 1];
    bool valid[G + 1];
    int step[G + 1];
#pragma unroll
    for (int u = 0; u <= G; ++u) {  // loads first: one latency for every key
      const int n = H[u] - L[u];
      step[u] = n > 32 ? n / 32 : 1;
      valid[u] = (lane + 1) * step[u] <= n;
      const int p = L[u] + (lane + 1) * step[u] - 1;
      if (first && u > 0) {  // the first level's probes are the same for every key
        probe[u] = probe[0];
      } else {
        probe[u] = valid[u] ? __ldg(slots + p) : 0;
      }
    }
    bool done = true;
#pragma unroll
    for (int u = 0; u <= G; ++u) {
      const int key = s0 + u * tile;
      const int c = __popc(__ballot_sync(FULL, valid[u] && probe[u] < key));
      H[u] = c == 32 ? H[u] : L[u] + (c + 1) * step[u] - 1;
      L[u] += c * step[u];
      done = done && L[u] == H[u];
    }
    if (done) break;  // uniform across the warp
  }
#pragma unroll
  for (int u = 0; u <= G; ++u) bound[u] = L[u];
}

template <int CG>
__global__ void __launch_bounds__(THREADS, 1)
scatter_ftrl_kernel(const float* __restrict__ d, const int32_t* __restrict__ slots,
                    const int32_t* __restrict__ win_off, const float* __restrict__ w_in,
                    const float* __restrict__ n_in, const float* __restrict__ z_in,
                    float* __restrict__ w_out, float* __restrict__ n_out,
                    float* __restrict__ z_out, int* __restrict__ counter,
                    int* __restrict__ nonfinite_count, int n_tiles, int k, int np, int bf16,
                    Ftrl hp) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[8];
  __shared__ TileInfo info[2];
  __shared__ int warp_bad[CWARPS];
  uint64_t* state_full = bars;       // [2], one arrival (with the copies' bytes)
  uint64_t* state_empty = bars + 2;  // [2], one arrival a consumer warp
  uint64_t* chunk_full = bars + 4;   // [2], one arrival (with the copies' bytes)
  uint64_t* chunk_empty = bars + 6;  // [2], one arrival a consumer warp

  const Geometry geo = geometry(k);
  const int tile = geo.tile, ch = geo.ch, ent = geo.ent;
  const int tk = tile * k;
  float* stage = reinterpret_cast<float*>(smem);    // [2][3][tk]
  float* chunks = stage + 6 * tk;                   // [2][1 + k][ch]
  float* acc = chunks + 2 * (1 + k) * ch;           // [tk]
  float* piece_sum = acc + tk;                      // [k][ent]
  int* piece_key = reinterpret_cast<int*>(piece_sum + k * ent);  // [ent]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      bar_init(state_full + b, 1);
      bar_init(state_empty + b, CWARPS);
      bar_init(chunk_full + b, 1);
      bar_init(chunk_empty + b, CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = threadIdx.x; e < tk; e += THREADS) acc[e] = 0.0f;
  __syncthreads();

  if (warp == CWARPS) {  // ---- the producer warp
    const uint64_t stream = evict_first();
    const uint32_t state_bytes = (uint32_t)tk * 4u;
    const int n_groups = n_tiles / GROUP;
    int g = 0;
    if (lane == 0) g = atomicAdd(counter, 1);
    g = __shfl_sync(FULL, g, 0);
    long long i = 0, j = 0;  // tiles and chunks issued
    for (;;) {
      int next = 0;
      if (lane == 0) next = atomicAdd(counter, 1);  // the next group, its latency under this one
      const bool live = g < n_groups;
      int bound[GROUP + 1];
      if (live) group_bounds<GROUP>(slots, win_off, np, g * GROUP * tile, tile, lane, bound);
      for (int u = 0; u < (live ? GROUP : 1); ++u, ++i) {
        const int t = g * GROUP + u;
        TileInfo inf{live ? t : -1, 0, 0, 0};
        if (live && bound[u + 1] > bound[u]) {
          inf.base = bound[u] & ~31;
          inf.lead = (bound[u] & ~3) - inf.base;
          inf.len = ((bound[u + 1] + 3) & ~3) - inf.base;
        }
        const int s = (int)(i & 1);
        bar_wait(state_empty + s, (uint32_t)((i >> 1) & 1) ^ 1u);
        if (lane == 0) {
          info[s] = inf;
          if (live) {
            float* dst = stage + s * 3 * tk;
            const long long at = (long long)t * tk;
            bar_arrive_tx(state_full + s, 3 * state_bytes);
            bulk_load(dst, w_in + at, state_bytes, state_full + s, stream);
            bulk_load(dst + tk, n_in + at, state_bytes, state_full + s, stream);
            bulk_load(dst + 2 * tk, z_in + at, state_bytes, state_full + s, stream);
          } else {
            bar_arrive(state_full + s);  // the end of the block's stream
          }
        }
        // the span in chunks of ch positions from base: the slots' row and
        // d's k rows over the staged part [lo, hi) of each, a row a lane
        for (int off = 0; off < inf.len; off += ch, ++j) {
          const int b = (int)(j & 1);
          const int lo = off > inf.lead ? off : inf.lead;
          const int hi = inf.len - off < ch ? inf.len : off + ch;
          const uint32_t row_bytes = (uint32_t)(hi - lo) * 4u;
          bar_wait(chunk_empty + b, (uint32_t)((j >> 1) & 1) ^ 1u);
          float* dst = chunks + b * (1 + k) * ch + (lo - off);
          const long long a = (long long)inf.base + lo;
          if (lane == 0) bar_arrive_tx(chunk_full + b, (uint32_t)(1 + k) * row_bytes);
          __syncwarp();
          for (int r = lane; r <= k; r += 32)
            bulk_load(dst + r * ch, r == 0 ? reinterpret_cast<const float*>(slots) + a
                                            : d + (long long)(r - 1) * np + a,
                      row_bytes, chunk_full + b, stream);
        }
      }
      if (!live) break;
      g = __shfl_sync(FULL, next, 0);
    }
    return;
  }

  // ---- the consumer warps: a tile's sums, then FTRL on it
  const int groups = (k + CG - 1) / CG;
  const float zero_frac = __fdiv_rn(0.0f, hp.alpha);
  int bad = 0;
  for (long long i = 0, j = 0;; ++i) {
    const int s = (int)(i & 1);
    bar_wait(state_full + s, (uint32_t)((i >> 1) & 1));
    const TileInfo inf = info[s];
    if (inf.tile < 0) break;
    const int s0 = inf.tile * tile;
    for (int off = 0; off < inf.len; off += ch, ++j) {
      const int b = (int)(j & 1);
      const int lo = off > inf.lead ? 0 : inf.lead - off;  // staged from here
      const int n = inf.len - off < ch ? inf.len - off : ch;
      const int pieces = (n + 31) >> 5;
      bar_wait(chunk_full + b, (uint32_t)((j >> 1) & 1));
      const int32_t* sl = reinterpret_cast<const int32_t*>(chunks + b * (1 + k) * ch);
      const float* dv = reinterpret_cast<const float*>(sl) + ch;
      // whether the run at position x - 1 goes on at x (both staged)
      auto goes_on = [&](int x) { return x > lo && x < n && sl[x - 1] == sl[x]; };
      bool joins = false;  // a run crosses a piece boundary inside the chunk
      if (sl[lo] == sl[n - 1]) {
        // the chunk is one run (a hot slot's middle): a lane sums every
        // 32nd position in order, then a butterfly; a warp a channel
        const int key = sl[lo];
        for (int c = warp; c < k; c += CWARPS) {
          float v = 0.0f;
          for (int x = lo + lane; x < n; x += 32) {
            float t = dv[c * ch + x];
            if (bf16) t = __bfloat162float(__float2bfloat16_rn(t));
            v = __fadd_rn(v, t);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
          if (lane == 0 && key >= s0 && key - s0 < tile) {
            float* a = acc + (key - s0) * k + c;
            *a = __fadd_rn(*a, v);
          }
        }
      } else {
        for (int q = 1; q < pieces; ++q) joins = joins || goes_on(q << 5);
        // pieces: a task is a piece of 32 positions (a lane a position) and
        // CG channels, a warp's tasks of one piece sharing its runs. A run
        // that crosses no piece boundary of the chunk is summed here whole;
        // the first and last run of a piece that does cross one go to the
        // piece table
        int cached = -1;
        Runs r;
        bool first_joins = false, last_joins = false, in = false;
        for (int task = warp; task < pieces * groups; task += CWARPS) {
          const int q = task / groups, c0 = (task - q * groups) * CG;
          const int x = (q << 5) + lane;
          if (q != cached) {
            cached = q;
            in = x >= lo && x < n;
            r = piece_runs(in ? sl[x] : KEY_NONE, lane);
            const bool cross_in = q > 0 && goes_on(q << 5);
            const bool cross_out = q + 1 < pieces && goes_on((q + 1) << 5);
            first_joins = cross_in || (r.single && cross_out);
            last_joins = cross_out || (r.single && cross_in);
            if (lane == 0) piece_key[2 * q] = first_joins ? r.key : KEY_NONE;
            if (lane == 31) piece_key[2 * q + 1] = last_joins ? r.key : KEY_NONE;
          }
          float v[CG];
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            v[c] = in && c0 + c < k ? dv[(c0 + c) * ch + x] : 0.0f;
            if (bf16) v[c] = __bfloat162float(__float2bfloat16_rn(v[c]));
          }
          run_scan<CG>(v, lane, r.start, r.longest);
          if (!r.last) continue;
          const bool table = (r.start == 0 && first_joins) || (lane == 31 && last_joins);
          const bool mine = r.key >= s0 && r.key - s0 < tile;
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            if (c0 + c >= k) break;
            if (!table) {  // a whole run: its sum
              if (mine) {
                float* a = acc + (r.key - s0) * k + c0 + c;
                *a = __fadd_rn(*a, v[c]);
              }
            } else {  // the piece's first run, its last run (0 when it has one)
              if (r.start == 0) piece_sum[(c0 + c) * ent + 2 * q] = v[c];
              if (lane == 31) piece_sum[(c0 + c) * ent + 2 * q + 1] = r.start == 0 ? 0.0f : v[c];
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(chunk_empty + b);
      if (joins) {
        consumers_sync();
        // join the table's runs in piece order: a task is CG channels, a
        // lane an entry
        for (int c0 = warp * CG; c0 < k; c0 += CWARPS * CG) {
          const int key = lane < 2 * pieces ? piece_key[lane] : KEY_NONE;
          const Runs r = piece_runs(key, lane);
          float v[CG];
#pragma unroll
          for (int c = 0; c < CG; ++c)
            v[c] = key != KEY_NONE && c0 + c < k ? piece_sum[(c0 + c) * ent + lane] : 0.0f;
          run_scan<CG>(v, lane, r.start, r.longest);
          if (r.last && r.key >= s0 && r.key - s0 < tile) {
#pragma unroll
            for (int c = 0; c < CG; ++c) {
              if (c0 + c >= k) break;
              float* a = acc + (r.key - s0) * k + c0 + c;
              *a = __fadd_rn(*a, v[c]);
            }
          }
        }
      }
      consumers_sync();  // the chunk's parts are in before the next chunk's, or FTRL
    }
    // FTRL on the tile: 16 B units of the flat [tile * k] stage, the sums
    // read and zeroed for the next tile
    const float4* w4 = reinterpret_cast<const float4*>(stage + s * 3 * tk);
    const float4* n4 = w4 + tk / 4;
    const float4* z4 = n4 + tk / 4;
    float4* g4 = reinterpret_cast<float4*>(acc);
    const long long at = (long long)inf.tile * tk;
    float4* wo = reinterpret_cast<float4*>(w_out + at);
    float4* no = reinterpret_cast<float4*>(n_out + at);
    float4* zo = reinterpret_cast<float4*>(z_out + at);
    for (int u = threadIdx.x; u < tk / 4; u += CONSUMERS) {
      const float4 w = w4[u], n = n4[u], z = z4[u], g = g4[u];
      g4[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 w1, n1, z1;
      ftrl_one(w.x, n.x, z.x, g.x, hp, zero_frac, w1.x, n1.x, z1.x, bad);
      ftrl_one(w.y, n.y, z.y, g.y, hp, zero_frac, w1.y, n1.y, z1.y, bad);
      ftrl_one(w.z, n.z, z.z, g.z, hp, zero_frac, w1.z, n1.z, z1.z, bad);
      ftrl_one(w.w, n.w, z.w, g.w, hp, zero_frac, w1.w, n1.w, z1.w, bad);
      __stcs(wo + u, w1);
      __stcs(no + u, n1);
      __stcs(zo + u, z1);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(state_empty + s);
    consumers_sync();  // the sums are zeroed before the next tile's
  }
  // the count: a warp's, then the block's, one atomic
  bad = __reduce_add_sync(FULL, bad);
  if (lane == 0) warp_bad[warp] = bad;
  consumers_sync();
  if (threadIdx.x == 0 && nonfinite_count != nullptr) {
    int total = 0;
    for (int w = 0; w < CWARPS; ++w) total += warp_bad[w];
    if (total) atomicAdd(nonfinite_count, total);
  }
}

}  // namespace

// num_slots must be a multiple of 2048 and under 2^31, np a multiple of 4
// and under 2^31; d, slots, w, n, z and the outputs 16 B aligned; 1 <= k
// <= 512 (the wrapper checks them). `counter` is one int32 of scratch (the
// tile counter, zeroed here); `nonfinite` is null or an int32 the count of
// non-finite outputs is added to.
extern "C" int xf_scatter_ftrl(const void* d, const void* slots, const void* win_off,
                               const void* w, const void* n, const void* z, void* w_out,
                               void* n_out, void* z_out, void* counter, void* nonfinite,
                               long long num_slots, int k, long long np, int bf16, float alpha,
                               float beta, float lambda1, float lambda2, void* stream) {
  if (num_slots <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(k);
  const long long n_groups = num_slots / geo.tile / GROUP;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = k >= WIDE_K ? scatter_ftrl_kernel<8> : scatter_ftrl_kernel<4>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  kernel<<<(unsigned)(sms < n_groups ? sms : n_groups), THREADS, (size_t)geo.smem, st>>>(
      (const float*)d, (const int32_t*)slots, (const int32_t*)win_off, (const float*)w,
      (const float*)n, (const float*)z, (float*)w_out, (float*)n_out, (float*)z_out,
      (int*)counter, (int*)nonfinite, (int)(num_slots / geo.tile), k, (int)np, bf16,
      Ftrl{alpha, beta, lambda1, lambda2});
  return (int)cudaGetLastError();
}
