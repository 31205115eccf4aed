// The staged walk of the windowed scatter-adds for Hopper (sm_90a):
// kernels #4 (`scatter_sorted.cu`, one buffer) and #6
// (`scatter_sorted_multi.cu`, nbuf buffers) launch the two kernels below.
// (#3, `scatter_ftrl.cu`, keeps the search-and-sum walk of
// `scatter_window.cuh`.)
//
// Contract: out[s, c] = sum of d[c, j] over positions j with slots[j] = s,
// for 0 <= s < S and c < K, every element of out written; slots outside
// [0, S) dropped; rows K..K8 of d ignored; with bf16 != 0 each term
// rounded to bfloat16 before the float32 add. The terms of a slot are
// added one at a time in stream order, from 0: its run in buffer 0, then
// in buffer 1, and so on, each in plan order (the order of `index_add_` on
// the CPU). No atomics, so the bits repeat from run to run.
//
// Input: nbuf buffers of cap positions each, concatenated (np = nbuf *
// cap), each slot-sorted on its own. The single-buffer scatter is nbuf =
// 1, cap = np. The plan's window offsets are not read: the tile offsets
// below are finer, and come from the slots themselves.
//
// Bound on the H100: bytes. The dense [S, K] output is written once and
// d[:K] and the slots are read once; one add per term. At the main paths'
// shapes the write is most of it (184.5 MB of 241 MB at S = 2^22, K = 11).
//
// Design. The output is cut into tiles of `tile` consecutive slots (256,
// fewer when K is so wide that a tile's sums would not fit in 64 KB).
//   0. `tile_offsets_kernel` marks, in one coalesced pass over the slots,
//      each tile's first position in each buffer: toff[i][T] is the first
//      position of buffer i whose slot is >= T * tile (a position writes
//      the entries of the tiles between its neighbour's slot and its own,
//      so each entry is written once), and zeroes a tile counter.
//   1. `staged_scatter_kernel` runs persistent blocks (as many as fit on
//      the card, 8 a SM). A block keeps one tile's [tile, K] sums in shared
//      memory and runs a stream of chunks through two chunk buffers. Its
//      warp 0 plans: it takes tiles from the counter, the last tile first
//      (the last tile holds every buffer's pads, 1,024 each at slot S - 1,
//      the longest run of a plan), copies toff's rows of a tile two tiles
//      ahead, and cuts each tile's spans into chunks: the spans' 16 B
//      aligned extents, packed buffer after buffer, at most `stage` (160)
//      positions a chunk, a span longer than the room left split in order.
//      At the main paths' shapes one chunk holds a tile (about 72
//      positions for FM, 4 x 18 for MVM's segment side).
//   2. Every thread copies its share of the next chunk into shared memory
//      by 16 B asynchronous copies (`cp.async`): the slots' row and d's K
//      rows over each piece (row stride np * 4 B; np is a multiple of 4),
//      while the block sums the chunk before it.
//   3. Sums: warp w takes channels [2w, 2w + 2) and walks the chunk's
//      pieces in stream order, 32 columns at a time, a lane a column. A
//      lane that starts a run (its slot differs from the column before)
//      adds the run's terms one by one to the tile's sum for (slot,
//      channel). A window that is all one run (a hot slot, the pads) is
//      extended to the run's end and summed a lane a channel. The runs of
//      one window are of distinct slots (a piece is sorted) and a warp's
//      windows follow one another, so each sum sees its terms in stream
//      order and no two threads touch one sum at once.
//   4. After a tile's last chunk its [tile, K] sums leave with 16 B
//      stores, coalesced (every tile starts 16 B aligned: tile * K * 4 B,
//      tile a multiple of 4), and are zeroed for the next tile.
// A hot slot's run is summed by one thread per channel, chunk after chunk:
// the order of the float32 adds is the contract, so its cost is serial.
//
// What was measured on the way (PERF.md §6): 1-D bulk copies
// (`cp.async.bulk`, mbarriers) of each tile's twelve ~300 B rows were
// slower than these 16 B copies; a block a tile (not persistent) left
// every tile's chain of dependent steps exposed; a warp's serial walk of
// the columns, or one warp issuing all copies, made the sums or the copies
// the chain; and the pads' run, summed a lane a column, made the last
// tile the kernel's tail.

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

// The tile of slot s: -1 below the table, n_tiles at or above its end.
__device__ __forceinline__ int tile_of(int32_t s, int tile, int n_tiles) {
  return s < 0 ? -1 : (s / tile < n_tiles ? s / tile : n_tiles);
}

// toff[i][T] (buffer-local, T in [0, n_tiles]) = the first position of
// buffer i whose slot is >= T * tile, or cap; then the tile counter, 0.
// Block (x, i) marks positions of buffer i.
__global__ void __launch_bounds__(THREADS)
tile_offsets_kernel(const int32_t* __restrict__ slots, int cap, int tile, int n_tiles,
                    int32_t* __restrict__ toff) {
  const int i = blockIdx.y;
  if (blockIdx.x == 0 && i == 0 && threadIdx.x == 0)
    toff[(long long)gridDim.y * (n_tiles + 1)] = 0;  // the tile counter
  const int32_t* sl = slots + (long long)i * cap;
  int32_t* off = toff + (long long)i * (n_tiles + 1);
  for (int j = blockIdx.x * THREADS + threadIdx.x; j < cap; j += gridDim.x * THREADS) {
    const int t = tile_of(__ldg(sl + j), tile, n_tiles);
    const int tp = j == 0 ? -1 : tile_of(__ldg(sl + j - 1), tile, n_tiles);
    for (int u = tp + 1; u <= t; ++u) off[u] = j;
    if (j == cap - 1)
      for (int u = (t > tp ? t : tp) + 1; u <= n_tiles; ++u) off[u] = cap;
  }
}

// Where the next chunk starts: buffer i, 16 B aligned position a inside
// that buffer's extent [span[2i] & ~3, (span[2i + 1] + 3) & ~3).
struct Cursor {
  int i;
  long long a;
};

// Move the cursor past spent and empty extents (i == nbuf: none left).
__device__ __forceinline__ void settle(const long long* span, int nbuf, Cursor& cur) {
  while (cur.i < nbuf &&
         (span[2 * cur.i] >= span[2 * cur.i + 1] || cur.a >= ((span[2 * cur.i + 1] + 3) & ~3LL))) {
    if (++cur.i < nbuf) cur.a = span[2 * cur.i] & ~3LL;
  }
}

// The pieces of the next chunk, in stream order: fn(i, a, n, col) for n
// positions of buffer i from a, at column col of the chunk.
template <typename F>
__device__ __forceinline__ void chunk_pieces(const long long* span, int nbuf, int stage,
                                             Cursor& cur, F fn) {
  int col = 0;
  while (col < stage && cur.i < nbuf) {
    const long long hi = (span[2 * cur.i + 1] + 3) & ~3LL;
    const int n = (int)(hi - cur.a < stage - col ? hi - cur.a : stage - col);
    fn(cur.i, cur.a, n, col);
    col += n;
    cur.a += n;
    settle(span, nbuf, cur);
  }
}

// 4 B from global to shared memory, asynchronously (LDGSTS).
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// A chunk buffer's header: its tile (-1: the block's stream has ended),
// its pieces, and whether it is its tile's last chunk.
struct ChunkMeta {
  long long tile;
  int pieces, last;
};

// A piece of a chunk: n4 16 B units of each row from position a, at
// column col; its used columns (the tile's positions) are [u0, u1).
struct Piece {
  long long a;
  int col, n4, u0, u1, pad0, pad1;
};

// Shared memory: the two chunks' headers and piece tables [nbuf]; the
// planner's tile ring [4], toff rows [3][2 nbuf] and span table [nbuf][p0,
// p1] (absolute); the sums [tile * k]; then two chunks of [1 + k][stage +
// PAD] 4 B words (slots, then d's rows). Every part and row starts 16 B
// aligned.
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
  l.acc = l.span + 16LL * nbuf;
  l.chunk = l.acc + 4LL * tile * k;
  l.chunk_bytes = 4LL * (1 + k) * (stage + PAD);
  l.total = l.chunk + 2 * l.chunk_bytes;
  return l;
}

// Entry q of a span table (q = 2i: buffer i's p0, q = 2i + 1: its p1)
// from toff's values v and, for buffer i's p0, v0; clamped into the
// buffer, so a plan that is not sorted cannot send a copy out of it.
__device__ __forceinline__ long long span_entry(int32_t v, int32_t v0, int q, long long cap) {
  long long p0 = v0 < 0 ? 0 : (v0 > cap ? cap : v0);
  long long p = v < 0 ? 0 : (v > cap ? cap : v);
  if (q & 1) p = p < p0 ? p0 : p;
  return (long long)(q >> 1) * cap + p;
}

// A persistent block runs a stream of chunks through two chunk buffers:
// warp 0 (the planner) takes tiles from a shared counter, the last tile
// first (it holds the plan's pads, 1,024 a buffer at slot S - 1), reads
// their span tables two tiles ahead and plans each chunk; every thread
// copies its share of the next chunk while all warps sum this one. A
// tile's last chunk is followed by its write.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
staged_scatter_kernel(const float* __restrict__ d, const int32_t* __restrict__ slots,
                      int32_t* __restrict__ toff, float* __restrict__ out, int k,
                      long long np, int nbuf, long long cap, long long n_tiles, int tile,
                      int stage, int bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(k, nbuf, tile, stage);
  const int row = stage + PAD;  // words a staged row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ChunkMeta* meta = reinterpret_cast<ChunkMeta*>(smem + lay.meta);
  Piece* pieces = reinterpret_cast<Piece*>(smem + lay.piece);  // [2][nbuf]
  long long* ring = reinterpret_cast<long long*>(smem + lay.ring);
  int32_t* raw = reinterpret_cast<int32_t*>(smem + lay.raw);  // [3][2 nbuf]
  long long* span = reinterpret_cast<long long*>(smem + lay.span);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  int* counter = toff + (long long)nbuf * (n_tiles + 1);  // zeroed by tile_offsets_kernel

  // ---- the planner (warp 0)
  auto grab = [&]() {  // lane 0: the next tile, from the last one down; -1 when none is left
    const long long r = atomicAdd(counter, 1);
    return r < n_tiles ? n_tiles - 1 - r : -1LL;
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
      for (int q = lane; q < 2 * nbuf; q += 32) span[q] = span_entry(rw[q], rw[q & ~1], q, cap);
      if (lane == 0) {
        ring[(jp + 3) & 3] = pending;
        pending = grab();
      }
      __syncwarp();
      fetch((jp + 2) % 3, ring[(jp + 2) & 3], false);
      cur = Cursor{0, span[0] & ~3LL};
      settle(span, nbuf, cur);
      started = true;
    }
    Piece* pc = pieces + b * nbuf;
    int npc = 0;
    chunk_pieces(span, nbuf, stage, cur, [&](int i, long long a, int n, int col) {
      const long long p0 = span[2 * i], p1 = span[2 * i + 1];
      const int u0 = col + (int)((p0 > a ? p0 : a) - a);
      const int u1 = col + (int)((p1 < a + n ? p1 : a + n) - a);
      if (u0 < u1) {  // a piece of the aligned extents' edges alone is not copied
        if (lane == 0) pc[npc] = Piece{a, col, n >> 2, u0, u1, 0, 0};
        ++npc;
      }
    });
    if (lane == 0) {
      m.tile = Tp;
      m.pieces = npc;
      m.last = cur.i >= nbuf;
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
  // (a hot slot; the pads) is extended to the run's end and summed a lane a
  // channel. A piece is sorted, so the runs of one window are of distinct
  // slots; a warp's windows follow one another (__syncwarp between), so
  // each sum sees its terms in stream order.
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
          const unsigned starts = __ballot_sync(0xffffffffu, start);
          if (starts == 1u) {
            const int32_t s_run = sl[w0];
            int e = w0;
            for (;;) {
              const int y = e + lane;
              const unsigned same = __ballot_sync(0xffffffffu, y < u.y && sl[y] == s_run);
              if (same != 0xffffffffu) {
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

// Slots a tile at K channels (0 for K outside [1, MAX_K]): the caller's
// scratch `toff` holds nbuf * (num_slots / tile + 1) + 1 int32 (the tile
// offsets, then the tile counter).
inline int tile_slots(int k) {
  int tile, stage;
  return geometry(k, 1, &tile, &stage) ? tile : 0;
}

// Both kernels over num_slots (a multiple of 2048) on `stream`; returns
// the CUDA error code (cudaErrorInvalidValue for K outside [1, MAX_K]).
inline int launch(const float* d, const int32_t* slots, int32_t* toff, float* out,
                  long long num_slots, int k, long long np, int nbuf, long long cap, int bf16,
                  cudaStream_t stream) {
  if (num_slots <= 0) return (int)cudaGetLastError();
  int tile, stage;
  const long long smem = geometry(k, nbuf, &tile, &stage);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const long long n_tiles = num_slots / tile;
  cudaError_t err;
  if (cap > 0) {
    const long long blocks = (cap + THREADS - 1) / THREADS;
    tile_offsets_kernel<<<dim3((unsigned)(blocks < 65535 ? blocks : 65535), (unsigned)nbuf),
                          THREADS, 0, stream>>>(slots, (int)cap, tile, (int)n_tiles, toff);
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
      d, slots, toff, out, k, np, nbuf, cap, n_tiles, tile, stage, bf16);
  return (int)cudaGetLastError();
}

}  // namespace xf_staged
