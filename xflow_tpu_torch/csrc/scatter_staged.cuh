// The staged walk of the windowed scatter-adds for Hopper (sm_90a):
// kernels #4 (`scatter_sorted.cu`, one buffer) and #6
// (`scatter_sorted_multi.cu`, nbuf buffers) launch the two kernels below.
// (#3, `scatter_ftrl.cu`, streams the state through its own walk.)
//
// Contract: out[s, c] = sum of d[c, j] over positions j with slots[j] = s,
// for 0 <= s < S and c < K, every element of out written; slots outside
// [0, S) dropped; rows K..K8 of d ignored; with bf16 != 0 each term
// rounded to bfloat16 before the float32 add. No atomics on the sums.
// A run is a maximal stretch of one slot inside one buffer. The order of
// the float32 adds is fixed by the plan alone (never by the grid, the SM
// count or timing), so two launches give the same bits:
//   - a run of at most RUN_H (256) positions adds its terms one at a time
//     in plan order;
//   - a longer run is cut on a fixed grid of CELL (256) positions of the
//     flattened stream: each piece (the run's positions in one cell) is
//     summed in plan order from 0, the pieces of each group of GROUP (64)
//     consecutive cells are added in cell order from 0, and the groups'
//     sums in group order from 0: the run's sum R;
//   - the slot's sum adds, from 0 in stream order (its run in buffer 0,
//     then in buffer 1, and so on), each term of a short run and each long
//     run's R, at the long run's place.
// So a slot whose runs are all short is summed as `index_add_` sums it on
// the CPU (plan order from 0), bitwise; the plain versions in
// `ops/sorted_table.py` reproduce the long runs' order with three more
// `index_add_` calls (pieces, groups, runs).
//
// Input: nbuf buffers of cap positions each, concatenated (np = nbuf *
// cap), each slot-sorted on its own. The single-buffer scatter is nbuf =
// 1, cap = np; with nbuf > 1, cap is a multiple of CELL, so no cell
// crosses a buffer. The plan's window offsets are not read: the tile
// offsets below are finer, and come from the slots themselves.
//
// Bound on the H100: bytes. The dense [S, K] output is written once and
// d[:K] and the slots are read once; one add per term. At the main paths'
// shapes the write is most of it (184.5 MB of 241 MB at S = 2^22, K = 11).
//
// Design. The output is cut into tiles of `tile` consecutive slots (256,
// fewer when K is so wide that a tile's sums would not fit in 64 KB).
//   0. `tile_offsets_kernel`, in one pass over the slots: a warp a cell of
//      CELL positions reads the cell's slots once (coalesced, PER a lane) and
//      a. marks each tile's first position in each buffer: toff[i][T] is
//         the first position of buffer i whose slot is >= T * tile (a
//         position writes the entries of the tiles between its
//         neighbour's slot and its own, so each entry is written once);
//      b. finds, by comparing neighbours in registers, the long run that
//         covers the cell's first position from an earlier cell (its head
//         piece) and the long run that starts inside the cell (its start
//         piece: at most one, as a long run is longer than a cell). One
//         probe RUN_H positions on decides whether a run is long; a warp
//         search (a probe a lane, 32-ary) finds a long run's end. The warp
//         sums each piece's K channels, a lane a (piece, channel), in plan
//         order by 16 B loads (their lines asked of L2 first), into a
//         scratch [cell][2][K], records the long run starting in the cell
//         (start, end), and lists the run's tile once (a flag a tile,
//         zeroed by a memset before the launch). A uniform plan's cells
//         find nothing: its runs are 1-3 long. Block 0 zeroes the tile
//         counter.
//   1. `staged_scatter_kernel` runs persistent blocks (as many as fit on
//      the card, 8 a SM). A block keeps one tile's [tile, K] sums in shared
//      memory and runs a stream of chunks through two chunk buffers. Its
//      warp 0 plans: it takes tiles from the counter, the listed tiles
//      first (the ones that hold a long run: their joins make them the
//      heaviest, and one taken last was the kernel's tail; the last tile,
//      with every buffer's 1,024 pads at slot S - 1, is one), then the
//      rest in order; copies toff's rows of
//      a tile two tiles ahead, and cuts each tile's spans into chunks: the
//      spans' 16 B aligned extents, packed buffer after buffer, at most
//      `stage` (160) positions a chunk, a span longer than the room left
//      split in order. Only a span longer than RUN_H can hold a long run:
//      there the planner reads the records of the (at most SPAN_CELLS)
//      cells a chunk's piece touches, ends the chunk where a long run starts, and
//      skips the run: its terms are never staged. At the main paths'
//      shapes one chunk holds a tile (about 72 positions for FM, 4 x 18
//      for MVM's segment side) and no span is that long.
//   2. Every thread copies its share of the next chunk into shared memory
//      by 16 B asynchronous copies (`cp.async`): the slots' row and d's K
//      rows over each piece (row stride np * 4 B; np is a multiple of 4),
//      while the block sums the chunk before it.
//   3. Sums: warp w takes channels [2w, 2w + 2) and walks the chunk's
//      pieces in stream order, 32 columns at a time, a lane a column. A
//      lane that starts a run (its slot differs from the column before)
//      adds the run's terms one by one to the tile's sum for (slot,
//      channel). A window that is all one run is extended to the run's end
//      (at most RUN_H) and summed a lane a channel. The runs of one window
//      are of distinct slots (a piece is sorted) and a warp's windows
//      follow one another, so each sum sees its terms in stream order and
//      no two threads touch one sum at once.
//   4. The join: a chunk that ends at a long run is followed, in each
//      warp after its channels' sums, by the run's join for those channels:
//      16 lanes a channel add the run's pieces from the scratch, a lane a
//      group in cell order, then the groups' sums in order (shuffles), and
//      R goes to the tile's sum at the run's place in the stream. No block
//      waits on another (the pieces were summed by the launch before), and
//      no barrier is needed (a warp owns its channels' sums).
//   5. After a tile's last chunk its [tile, K] sums leave with 16 B
//      stores, coalesced (every tile starts 16 B aligned: tile * K * 4 B,
//      tile a multiple of 4), and are zeroed for the next tile.
//
// What was measured on the way (PERF.md §6): 1-D bulk copies
// (`cp.async.bulk`, mbarriers) of each tile's twelve ~300 B rows were
// slower than these 16 B copies; a block a tile (not persistent) left
// every tile's chain of dependent steps exposed; a warp's serial walk of
// the columns, or one warp issuing all copies, made the sums or the copies
// the chain. Before long runs were split, a hot slot's run was
// summed by one thread a channel: 1.10 ms for a run of 65,536 at K = 11,
// 17.6 ms for the fully-sharded buffer's 1,180,160 pads at one slot.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xf_staged {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 8;                 // blocks a SM: 32 registers a thread
constexpr int MAX_TILE = 256;                 // slots a tile
constexpr int MAX_STAGE = 160;                // positions a chunk
constexpr int CPW = 2;                        // channels a warp sums
constexpr int PAD = 4;                        // words after each staged row (banks)
constexpr long long ACC_BYTES = 64 * 1024;    // the tile's sums
constexpr long long STAGE_BYTES = 8 * 1024;   // one chunk of slots and d[:K]
// Widest K: a tile of 8 slots' sums (64 KB) and two 4-position chunks
// (2 x 64 KB) fit in the 227 KB of shared memory a block may take.
constexpr int MAX_K = 2048;
// Long runs (the contract above). RUN_H == CELL: a run longer than a cell
// covers the end of the cell it starts in, so a cell holds at most one
// long run's start, and a run that covers a whole cell and the position
// before it is long. A cell is PER positions a lane of a warp; a chunk's
// piece spans at most SPAN_CELLS cells.
constexpr int RUN_H = 256;
constexpr int CELL = 256;
constexpr int GROUP = 64;
constexpr int PER = CELL / 32;
constexpr int SPAN_CELLS = (MAX_STAGE + 2) / CELL + 2;
constexpr int NONE = -1;
constexpr unsigned FULL = 0xffffffffu;
static_assert(RUN_H == CELL && (PER == 4 || PER == 8), "see the contract");
static_assert(CPW == 2, "join_run gives each channel of a warp half the lanes");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B from global to shared memory, asynchronously (LDGSTS, L2 only).
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tile of slot s (tiles of 2^shift slots): -1 below the table,
// n_tiles at or above its end.
__device__ __forceinline__ int tile_of(int32_t s, int shift, int n_tiles) {
  return s < 0 ? -1 : ((s >> shift) < n_tiles ? (s >> shift) : n_tiles);
}

// One term, rounded to bfloat16 first if asked, added to a float32 sum.
__device__ __forceinline__ float add_term(float total, float x, int bf16) {
  if (bf16) x = __bfloat162float(__float2bfloat16_rn(x));
  return __fadd_rn(total, x);
}

// The first position in (p, hi) whose slot is not s, or hi, in a sorted
// buffer with sl[p] == s; every lane of the warp calls it and gets it.
// One probe a lane a level: p + 2^lane first, then 32-ary narrowing.
__device__ long long warp_run_end(const int32_t* __restrict__ sl, long long p, long long hi,
                                  int32_t s, int lane) {
  const long long q = p + (1LL << lane);
  const int m = __popc(__ballot_sync(FULL, lane < 31 && q < hi && __ldg(sl + q) == s));
  long long lo = m ? p + (1LL << (m - 1)) : p;  // a position of the run
  long long up = p + (1LL << m) < hi ? p + (1LL << m) : hi;  // the end is in (lo, up]
  while (up - lo > 1) {
    const long long step = (up - lo + 31) / 32;
    const long long x = lo + step * (lane + 1);
    lo += step * __popc(__ballot_sync(FULL, x < up && __ldg(sl + x) == s));
    if (lo + step < up) up = lo + step;
  }
  return up;
}

// Cell cl of buffer i (positions [base + cl * CELL, ...)), by one warp,
// from the cell's slots read once (8 a lane): (a) the tile offsets its
// positions mark (`off` = toff[i]); (b) the long runs' pieces in it summed
// into psum[cell][0] (head: the long run that covers the cell's first
// position from an earlier cell) and psum[cell][1] (start: the long run
// that starts in the cell), and the start's run recorded as (ls, le)
// (absolute positions; ls NONE if none).
__device__ void mark_cell(const float* __restrict__ d, const int32_t* __restrict__ sl,
                          long long cap, long long base, long long np, int k, int num_slots,
                          int shift, int n_tiles, int bf16, long long cl, int32_t* __restrict__ off,
                          int32_t* __restrict__ ls, int32_t* __restrict__ le,
                          int32_t* __restrict__ heavy, float* __restrict__ psum, int lane) {
  const long long cs = cl * CELL, ce = cs + CELL < cap ? cs + CELL : cap;
  const long long c = (base + cs) / CELL;  // the cell's index in the flattened stream
  const long long p = cs + (long long)PER * lane;
  int32_t v[PER];
#pragma unroll
  for (int h = 0; h < PER / 4; ++h) {  // the cell's slots, PER a lane (ce - cs: a multiple of 4)
    int4 q = make_int4(0, 0, 0, 0);
    if (p + 4 * h < ce) q = __ldg(reinterpret_cast<const int4*>(sl + p + 4 * h));
    v[4 * h] = q.x, v[4 * h + 1] = q.y, v[4 * h + 2] = q.z, v[4 * h + 3] = q.w;
  }
  const int32_t s_prev = cs > 0 ? __ldg(sl + cs - 1) : 0;
  const int32_t s_next = ce < cap ? __ldg(sl + ce) : 0;
  const int32_t s0 = __shfl_sync(FULL, v[0], 0);
  const int last = (int)(ce - cs - 1);  // the cell's last position: lane last / PER
  const int32_t s_last = __shfl_sync(FULL, (last % PER) == 7 ? v[PER - 1] : v[3], last / PER);
  int32_t prev = __shfl_up_sync(FULL, v[PER - 1], 1);
  if (lane == 0) prev = s_prev;
  int first_diff = CELL, last_start = -1;  // cell offsets
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const long long j = p + e;
    if (j < ce) {
      const int32_t pv = e == 0 ? prev : v[e - 1];
      // (a) position j writes the offsets of the tiles between its
      // neighbour's slot and its own, so each entry is written once
      const int t = tile_of(v[e], shift, n_tiles), tp = j == 0 ? -1 : tile_of(pv, shift, n_tiles);
      for (int u = tp + 1; u <= t; ++u) off[u] = (int32_t)j;
      if (j == cap - 1)
        for (int u = (t > tp ? t : tp) + 1; u <= n_tiles; ++u) off[u] = (int32_t)cap;
      if (v[e] != s0 && first_diff == CELL) first_diff = PER * lane + e;
      if (j == 0 || v[e] != pv) last_start = PER * lane + e;
    }
  }
  first_diff = __reduce_min_sync(FULL, first_diff);
  last_start = __reduce_max_sync(FULL, last_start);
  // the head: [cs, he)
  long long he = cs;
  if (cs > 0 && s_prev == s0 && s0 >= 0 && s0 < num_slots) {
    const long long r1 = cs + first_diff < ce ? cs + first_diff : ce;
    bool is_long = true;  // covering cs - 1 .. ce: CELL + 1 > RUN_H positions
    if (r1 < ce || ce == cap)  // the run ends at r1: long iff it holds r1 - RUN_H - 1
      is_long = r1 - RUN_H - 1 >= 0 && __ldg(sl + r1 - RUN_H - 1) == s0;
    if (is_long) he = r1;
  }
  // the start: [qs, ce), the run that starts at q = cs + last_start (its
  // slot is the cell's last), if long: it must go on past the cell, to q + RUN_H
  long long qs = ce;
  if (last_start >= 0 && ce < cap && s_next == s_last && s_last >= 0 && s_last < num_slots) {
    const long long q = cs + last_start;
    if (q + RUN_H < cap && __ldg(sl + q + RUN_H) == s_last) {
      const long long end = warp_run_end(sl, q + RUN_H, cap, s_last, lane);
      qs = q;
      if (lane == 0) {
        ls[c] = (int32_t)(base + q);
        le[c] = (int32_t)(base + end);
        // list the run's tile once: heavy = [flags n_tiles][count][list]
        const int T = s_last >> shift;
        if (atomicExch(heavy + T, 1) == 0) heavy[n_tiles + 1 + atomicAdd(heavy + n_tiles, 1)] = T;
      }
    }
  }
  if (qs == ce && lane == 0) ls[c] = NONE;
  if (he == cs && qs == ce) return;  // no piece: the uniform plans' cells
  // the pieces' sums, a lane a (piece, channel), in plan order; their rows'
  // lines asked of L2 first, so the loads below do not wait on memory
  for (int t = lane; t < 2 * k; t += 32) {
    const int h = t >= k;
    const long long a0 = h ? qs : cs, a1 = h ? ce : he;
    const float* row = d + (long long)(t - h * k) * np + base;
    for (long long y = a0 & ~31LL; y < a1; y += 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(row + y));
  }
  for (int t = lane; t < 2 * k; t += 32) {
    const int h = t >= k, ch = t - h * k;
    const long long a0 = h ? qs : cs, a1 = h ? ce : he;
    if (a0 >= a1) continue;
    const float4* row = reinterpret_cast<const float4*>(d + (long long)ch * np + base);
    const int b0 = (int)(a0 - cs), b1 = (int)(a1 - cs);  // the piece in cell offsets
    float total = 0.0f;
    for (int y0 = b0 & ~3; y0 < b1; y0 += 32) {  // 8 loads in flight, then their adds
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        x[u] = y0 + 4 * u < b1 ? __ldg(row + (cs + y0) / 4 + u) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // adding 0 for a position outside leaves the bits
        const int y = y0 + 4 * u;
        total = add_term(total, y >= b0 && y < b1 ? x[u].x : 0.0f, bf16);
        total = add_term(total, y + 1 >= b0 && y + 1 < b1 ? x[u].y : 0.0f, bf16);
        total = add_term(total, y + 2 >= b0 && y + 2 < b1 ? x[u].z : 0.0f, bf16);
        total = add_term(total, y + 3 >= b0 && y + 3 < b1 ? x[u].w : 0.0f, bf16);
      }
    }
    psum[(c * 2 + h) * k + ch] = total;
  }
}

// toff[i][T] (buffer-local, T in [0, n_tiles]) = the first position of
// buffer i whose slot is >= T * tile, or cap; then the tile counter, 0;
// then the cells' records ls [ncells], le [ncells]; then the heavy tiles:
// a flag a tile and a count (zeroed before the launch), and the list of
// tiles that hold a long run, each once. A warp a cell (`mark_cell`);
// block (x, i) works on buffer i.
__global__ void __launch_bounds__(THREADS)
tile_offsets_kernel(const float* __restrict__ d, const int32_t* __restrict__ slots, long long np,
                    int cap, int k, int shift, int n_tiles, int num_slots, int bf16,
                    int32_t* __restrict__ toff, float* __restrict__ psum) {
  const int i = blockIdx.y;
  int32_t* ls = toff + (long long)gridDim.y * (n_tiles + 1) + 1;
  int32_t* le = ls + (np + CELL - 1) / CELL;
  int32_t* heavy = le + (np + CELL - 1) / CELL;  // zeroed flags and count (launch's memset)
  if (blockIdx.x == 0 && i == 0 && threadIdx.x == 0)
    toff[(long long)gridDim.y * (n_tiles + 1)] = 0;  // the tile counter
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cells = ((long long)cap + CELL - 1) / CELL;
  for (long long cl = (long long)blockIdx.x * (THREADS / 32) + warp; cl < cells;
       cl += (long long)gridDim.x * (THREADS / 32))
    mark_cell(d, slots + (long long)i * cap, cap, (long long)i * cap, np, k, num_slots, shift,
              n_tiles, bf16, cl, toff + (long long)i * (n_tiles + 1), ls, le, heavy, psum, lane);
}

// 4 B from global to shared memory, asynchronously (LDGSTS).
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// A chunk buffer's header: its tile (-1: the block's stream has ended),
// its pieces, whether it is its tile's last chunk, and the long run
// [join, join_end) that follows its pieces (join -1: none).
struct ChunkMeta {
  long long tile;
  int pieces, last, join, join_end;
};

// A piece of a chunk: n4 16 B units of each row from position a, at
// column col; its used columns (the tile's positions) are [u0, u1).
struct Piece {
  long long a;
  int col, n4, u0, u1, pad0, pad1;
};

// Where the next chunk starts: lo, the next position of buffer i's span
// to sum (i == nbuf: none left). Its copy starts at lo & ~3.
struct Cursor {
  int i, lo;
};

// Move the cursor past spent and empty spans.
__device__ __forceinline__ void settle(const int* span, int nbuf, Cursor& cur) {
  while (cur.i < nbuf && cur.lo >= span[2 * cur.i + 1])
    if (++cur.i < nbuf) cur.lo = span[2 * cur.i];
}

// Shared memory: the two chunks' headers and piece tables [nbuf]; the
// planner's tile ring [4], toff rows [3][2 nbuf] and span table [nbuf][p0,
// p1] (absolute positions, int32: np < 2^31); the sums [tile * k]; then
// two chunks of [1 + k][stage + PAD] 4 B words (slots, then d's rows).
// Every part and row starts 16 B aligned.
struct Layout {
  long long meta, piece, ring, raw, span, acc, chunk, chunk_bytes, total;
};

__host__ __device__ inline Layout layout(int k, int nbuf, int tile, int stage) {
  Layout l;
  l.meta = 0;
  l.piece = l.meta + 2 * (long long)sizeof(ChunkMeta);
  l.ring = l.piece + 2 * (long long)sizeof(Piece) * nbuf;
  l.raw = l.ring + 32;
  l.span = l.raw + 16LL * ((3 * 2 * nbuf + 3) / 4);
  l.acc = l.span + 16LL * nbuf;  // 8 B a buffer would do: this size keeps the registers
  l.chunk = l.acc + 4LL * tile * k;
  l.chunk_bytes = 4LL * (1 + k) * (stage + PAD);
  l.total = l.chunk + 2 * l.chunk_bytes;
  return l;
}

// Entry q of a span table (q = 2i: buffer i's p0, q = 2i + 1: its p1)
// from toff's values v and, for buffer i's p0, v0; clamped into the
// buffer, so a plan that is not sorted cannot send a copy out of it.
__device__ __forceinline__ int span_entry(int32_t v, int32_t v0, int q, int cap) {
  int p0 = v0 < 0 ? 0 : (v0 > cap ? cap : v0);
  int p = v < 0 ? 0 : (v > cap ? cap : v);
  if (q & 1) p = p < p0 ? p0 : p;
  return (q >> 1) * cap + p;
}

// The long run [r0, r1) at tile slot t, by one warp for channels [c0, c0
// + CPW): half h of the warp takes channel c0 + h, its lane g the groups
// g0 + g, g0 + g + 16, ...; a lane adds its group's pieces from psum in
// cell order from 0; the half adds the groups' sums in group order from
// 0 (shuffles), and lane 0 of the half adds R to the tile's sum. Not
// inlined: it keeps the chunk loop's registers.
__device__ __noinline__ void join_run(float* acc, const float* __restrict__ psum, int r0, int r1,
                                      int t, int c0, int k, int lane) {
  const long long cf = r0 / CELL, cl = (r1 - 1) / CELL, g0 = cf / GROUP, g1 = cl / GROUP;
  const int c = c0 + (lane >> 4), gl = lane & 15;
  float total = 0.0f;  // R, on every lane of the half
  for (long long gb = g0; gb <= g1; gb += 16) {
    const long long g = gb + gl;
    float part = 0.0f;
    if (g <= g1 && c < k) {
      const long long ca = cf > g * GROUP ? cf : g * GROUP;
      const long long cb = cl < g * GROUP + GROUP - 1 ? cl : g * GROUP + GROUP - 1;
#pragma unroll 8
      for (long long x = ca; x <= cb; ++x)
        part = __fadd_rn(part, __ldg(psum + (x * 2 + (x == cf)) * k + c));
    }
    for (int j = 0; j < 16; ++j) {
      const float y = __shfl_sync(FULL, part, (lane & 16) | j);
      if (gb + j <= g1) total = __fadd_rn(total, y);
    }
  }
  if (gl == 0 && c < k) acc[t * k + c] = __fadd_rn(acc[t * k + c], total);
}

// A persistent block runs a stream of chunks through two chunk buffers:
// warp 0 (the planner) takes tiles from a shared counter, the listed
// (heavy) tiles first, reads their span tables two tiles ahead and plans
// each chunk;
// every thread copies its share of the next chunk while all warps sum this
// one (and the long run that ends it, if any). A tile's last chunk is
// followed by its write.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
staged_scatter_kernel(const float* __restrict__ d, const int32_t* __restrict__ slots,
                      int32_t* __restrict__ toff, const float* __restrict__ psum,
                      float* __restrict__ out, int k, long long np, int nbuf, long long cap,
                      long long n_tiles, int tile, int stage, int bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(k, nbuf, tile, stage);
  const int row = stage + PAD;  // words a staged row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ChunkMeta* meta = reinterpret_cast<ChunkMeta*>(smem + lay.meta);
  Piece* pieces = reinterpret_cast<Piece*>(smem + lay.piece);  // [2][nbuf]
  long long* ring = reinterpret_cast<long long*>(smem + lay.ring);
  int32_t* raw = reinterpret_cast<int32_t*>(smem + lay.raw);  // [3][2 nbuf]
  int* span = reinterpret_cast<int*>(smem + lay.span);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  int* counter = toff + (long long)nbuf * (n_tiles + 1);  // zeroed by tile_offsets_kernel

  // ---- the planner (warp 0)
  // lane 0: the next tile, the listed (heavy) ones first, in the list's
  // order (heavy = [flags n_tiles][count][list], tile_offsets_kernel), then
  // the others in order; -1 when none is left
  auto grab = [&]() -> long long {
    const int* heavy = counter + 1 + 2 * ((np + CELL - 1) / CELL);
    for (;;) {
      const int r = atomicAdd(counter, 1), nh = __ldg(heavy + n_tiles);
      if (r < nh) return __ldg(heavy + n_tiles + 1 + r);
      if (r - nh >= n_tiles) return -1;
      if (__ldg(heavy + r - nh) == 0) return r - nh;  // a listed tile went first
    }
  };
  // toff rows of tile T into raw slot r: entry q is toff[q / 2][T + q % 2]
  auto fetch = [&](int r, long long T, bool now) {
    if (T < 0) return;
    for (int q = lane; q < 2 * nbuf; q += 32) {
      const int32_t* src = toff + (long long)(q >> 1) * (n_tiles + 1) + T + (q & 1);
      if (now)
        raw[r * 2 * nbuf + q] = __ldg(src);
      else
        copy4(raw + r * 2 * nbuf + q, src);
    }
  };
  int jp = 0;             // the planner's tile count
  long long pending = 0;  // lane 0: a grabbed tile not yet in the ring
  bool started = false;   // whether tile jp has issued a chunk
  Cursor cur{nbuf, 0};    // where tile jp's next chunk starts
  // Plan chunk buffer b's next chunk of the stream: its header and pieces.
  auto plan = [&](int b) {
    ChunkMeta& m = meta[b];
    const long long Tp = ring[jp & 3];
    if (Tp < 0) {
      if (lane == 0) m.tile = -1;
      return;
    }
    if (!started) {  // tile jp begins: its span table, the ring refilled
      const int32_t* rw = raw + (jp % 3) * 2 * nbuf;
      for (int q = lane; q < 2 * nbuf; q += 32)
        span[q] = span_entry(rw[q], rw[q & ~1], q, (int)cap);
      if (lane == 0) {
        ring[(jp + 3) & 3] = pending;
        pending = grab();
      }
      __syncwarp();
      fetch((jp + 2) % 3, ring[(jp + 2) & 3], false);
      cur = Cursor{0, span[0]};
      settle(span, nbuf, cur);
      started = true;
    }
    Piece* pc = pieces + b * nbuf;
    int npc = 0, col = 0;
    int r0 = -1, r1 = 0;  // the long run that ends the chunk
    while (col < stage && cur.i < nbuf) {
      const int p1 = span[2 * cur.i + 1], lo = cur.lo, a = lo & ~3;
      const int hi = (p1 + 3) & ~3;
      int n = hi - a < stage - col ? hi - a : stage - col;
      int u1 = p1 < a + n ? p1 : a + n;  // positions [lo, u1) of the span
      if (p1 - span[2 * cur.i] > RUN_H) {  // a span this long may hold a long run
        int at = -1, end = 0;
        const int cc = lo / CELL + lane;
        if (lane < SPAN_CELLS && cc * CELL < u1) {  // the cells' records (tile_offsets_kernel)
          const int32_t* ls = toff + (long long)nbuf * (n_tiles + 1) + 1;
          const int32_t s = __ldg(ls + cc);
          if (s >= lo && s < u1) at = s, end = __ldg(ls + (np + CELL - 1) / CELL + cc);
        }
        const unsigned found = __ballot_sync(FULL, at >= 0);  // at most one: a long run
        if (found) {                                          // is longer than a chunk
          r0 = __shfl_sync(FULL, at, __ffs(found) - 1);
          r1 = __shfl_sync(FULL, end, __ffs(found) - 1);
          u1 = r0;
          n = ((r0 + 3) & ~3) - a;
        }
      }
      if (lo < u1) {  // a piece of the aligned extents' edges alone is not copied
        if (lane == 0) pc[npc] = Piece{a, col, n >> 2, col + lo - a, col + u1 - a, 0, 0};
        ++npc;
        col += n;
      }
      cur.lo = r0 >= 0 ? r1 : a + n;
      settle(span, nbuf, cur);
      if (r0 >= 0) break;
    }
    if (lane == 0) {
      m.tile = Tp;
      m.pieces = npc;
      m.last = cur.i >= nbuf;
      m.join = r0;
      m.join_end = r1;
    }
    if (cur.i >= nbuf) {
      ++jp;
      started = false;
    }
  };
  // Every thread copies its share of chunk buffer b's planned pieces: the
  // slots' row and d's K rows, 16 B at a time.
  auto copy_chunk = [&](int b) {
    if (meta[b].tile < 0) return;
    unsigned char* dst = smem + lay.chunk + b * lay.chunk_bytes;
    const Piece* pc = pieces + b * nbuf;
    for (int p = 0, npc = meta[b].pieces, first = 0; p < npc; ++p) {
      const Piece pp = pc[p];
      const int units = (1 + k) * pp.n4;
      // piece p's units start at the thread after piece p - 1's last one
      for (int e = (threadIdx.x - first + THREADS * 64) % THREADS; e < units; e += THREADS) {
        const int r = e / pp.n4, u = e - r * pp.n4;
        const float* src = r == 0 ? reinterpret_cast<const float*>(slots) + pp.a
                                  : d + (long long)(r - 1) * np + pp.a;
        copy16(dst + 4LL * (r * row + pp.col + 4 * u), src + 4 * u);
      }
      first = (first + units) % THREADS;
    }
  };

  // ---- the consumers (every warp)
  // Sum chunk buffer b into the tile's sums. Warp w takes channels [CPW w,
  // CPW w + CPW) (then + 8 CPW, ...) and walks the chunk's pieces in stream
  // order, 32 used columns at a time, a lane a column. A lane that starts a
  // run (its slot differs from the column before, or the window starts
  // there) adds the run's terms one by one. A window that is all one run
  // is extended to the run's end and summed a lane a channel. A piece is
  // sorted, so the runs of one window are of distinct slots; a warp's
  // windows follow one another (__syncwarp between), so each sum sees its
  // terms in stream order.
  auto add_terms = [&](float total, const float* dc, int y0, int y1) {
    if (bf16) {
#pragma unroll 8
      for (int y = y0; y < y1; ++y)
        total = __fadd_rn(total, __bfloat162float(__float2bfloat16_rn(dc[y])));
    } else {
#pragma unroll 8
      for (int y = y0; y < y1; ++y) total = __fadd_rn(total, dc[y]);
    }
    return total;
  };
  auto sum_chunk = [&](int b, long long s0) {
    const int32_t* sl = reinterpret_cast<const int32_t*>(smem + lay.chunk + b * lay.chunk_bytes);
    const float* dv = reinterpret_cast<const float*>(sl) + row;
    const Piece* pc = pieces + b * nbuf;
    const int npc = meta[b].pieces;
    for (int c0 = warp * CPW; c0 < k; c0 += THREADS / 32 * CPW) {
      const int c1 = c0 + CPW < k ? c0 + CPW : k;
      for (int p = 0; p < npc; ++p) {
        const int2 u = make_int2(pc[p].u0, pc[p].u1);
        for (int w0 = u.x; w0 < u.y;) {
          const int x = w0 + lane;
          const int w1 = w0 + 32 < u.y ? w0 + 32 : u.y;
          const int32_t s = x < w1 ? sl[x] : 0;
          const bool start = x < w1 && (lane == 0 || sl[x - 1] != s);
          const unsigned starts = __ballot_sync(FULL, start);
          if (starts == 1u) {
            const int32_t s_run = sl[w0];
            int e = w0;
            for (;;) {
              const int y = e + lane;
              const unsigned same = __ballot_sync(FULL, y < u.y && sl[y] == s_run);
              if (same != FULL) {
                e += __ffs(~same) - 1;
                break;
              }
              e += 32;
            }
            const long long t = (long long)s_run - s0;
            const int c = c0 + lane;
            if (c < c1 && t >= 0 && t < tile)
              acc[t * k + c] = add_terms(acc[t * k + c], dv + c * row, w0, e);
            w0 = e;
          } else {
            const unsigned above = starts & ~((2u << lane) - 1u);
            const int end = above ? w0 + __ffs(above) - 1 : w1;
            const long long t = (long long)s - s0;
            if (start && t >= 0 && t < tile)
              for (int c = c0; c < c1; ++c)
                acc[t * k + c] = add_terms(acc[t * k + c], dv + c * row, x, end);
            w0 = w1;
          }
          __syncwarp();
        }
      }
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      for (int r = 0; r < 3; ++r) ring[r] = grab();
      pending = grab();
    }
    __syncwarp();
    fetch(0, ring[0], true);
    fetch(1, ring[1], true);
    __syncwarp();
    plan(0);
  }
  for (int e = threadIdx.x; e < tile * k / 4; e += THREADS)
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  copy_chunk(0);
  copy_commit();
  for (int n = 0;; ++n) {
    const int b = n & 1;
    if (warp == 0) plan(b ^ 1);
    __syncthreads();
    copy_chunk(b ^ 1);
    copy_commit();
    copy_wait<1>();  // chunk n has landed (chunk n + 1 may not have)
    __syncthreads();
    const long long T = meta[b].tile;
    if (T < 0) break;
    sum_chunk(b, T * tile);
    if (meta[b].join >= 0)  // the long run after the chunk, a warp its channels' sums
      for (int c0 = warp * CPW; c0 < k; c0 += THREADS / 32 * CPW)
        join_run(acc, psum, meta[b].join, meta[b].join_end,
                 (int)(__ldg(slots + meta[b].join) - T * tile), c0, k, lane);
    if (meta[b].last) {  // the tile's sums out, 16 B a thread, and zeroed
      __syncthreads();
      float4* a4 = reinterpret_cast<float4*>(acc);
      float4* o4 = reinterpret_cast<float4*>(out + T * tile * k);
      for (int e = threadIdx.x; e < tile * k / 4; e += THREADS) {
        o4[e] = a4[e];
        a4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    __syncthreads();
  }
}

// Tile and chunk sizes for K channels: the tile's sums within ACC_BYTES,
// a chunk within STAGE_BYTES. Returns the shared memory a block takes, or
// 0 for K outside [1, MAX_K].
inline long long geometry(int k, int nbuf, int* tile, int* stage) {
  if (k < 1 || k > MAX_K) return 0;
  int t = MAX_TILE;
  while (t > 4 && 4LL * t * k > ACC_BYTES) t >>= 1;
  long long s = (STAGE_BYTES / (4LL * (1 + k)) - PAD) & ~3LL;
  s = s < 4 ? 4 : (s > MAX_STAGE ? MAX_STAGE : s);
  *tile = t;
  *stage = (int)s;
  return layout(k, nbuf, t, (int)s).total;
}

// Slots a tile at K channels (0 for K outside [1, MAX_K]).
inline int tile_slots(int k) {
  int tile, stage;
  return geometry(k, 1, &tile, &stage) ? tile : 0;
}

// The scratch a launch needs: int32 words (the tile offsets, the tile
// counter, the cells' records, the heavy tiles' flags, count and list)
// and float32 words (the pieces' sums).
inline long long scratch_ints(long long num_slots, int k, long long np, int nbuf) {
  const int tile = tile_slots(k);
  return tile ? nbuf * (num_slots / tile + 1) + 1 + 3 * ((np + CELL - 1) / CELL) +
                    num_slots / tile + 1
              : 0;
}

inline long long scratch_floats(int k, long long np) {
  return 2LL * k * ((np + CELL - 1) / CELL);
}

// Both kernels over num_slots (a multiple of 2048) on `stream`, with the
// caller's scratch (toff: n_ints int32, psum: n_floats float32); returns
// the CUDA error code (cudaErrorInvalidValue for K outside [1, MAX_K], a
// scratch too small, or nbuf > 1 with cap not a multiple of CELL).
inline int launch(const float* d, const int32_t* slots, int32_t* toff, long long n_ints,
                  float* psum, long long n_floats, float* out, long long num_slots, int k,
                  long long np, int nbuf, long long cap, int bf16, cudaStream_t stream) {
  if (num_slots <= 0) return (int)cudaGetLastError();
  int tile, stage;
  const long long smem = geometry(k, nbuf, &tile, &stage);
  if (smem == 0 || n_ints < scratch_ints(num_slots, k, np, nbuf) ||
      n_floats < scratch_floats(k, np) || (nbuf > 1 && cap % CELL))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = num_slots / tile, cells = (np + CELL - 1) / CELL;
  cudaError_t err = cudaMemsetAsync(toff + nbuf * (n_tiles + 1) + 1 + 2 * cells, 0,
                                    sizeof(int32_t) * (n_tiles + 1), stream);  // heavy flags
  if (err != cudaSuccess) return (int)err;
  if (cap > 0) {
    const long long blocks = ((cap + CELL - 1) / CELL + THREADS / 32 - 1) / (THREADS / 32);
    tile_offsets_kernel<<<dim3((unsigned)(blocks < 65535 ? blocks : 65535), (unsigned)nbuf),
                          THREADS, 0, stream>>>(d, slots, np, (int)cap, k, __builtin_ctz(tile),
                                                (int)n_tiles,
                                                (int)num_slots, bf16, toff, psum);
  } else {
    err = cudaMemsetAsync(toff, 0, sizeof(int32_t) * (nbuf * (n_tiles + 1) + 1), stream);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(staged_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, staged_scatter_kernel, THREADS,
                                                           (size_t)smem)) != cudaSuccess)
    return (int)err;
  const long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  staged_scatter_kernel<<<(unsigned)(grid < n_tiles ? grid : n_tiles), THREADS, (size_t)smem,
                          stream>>>(
      d, slots, toff, psum, out, k, np, nbuf, cap, n_tiles, tile, stage, bf16);
  return (int)cudaGetLastError();
}

}  // namespace xf_staged
