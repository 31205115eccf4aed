// Native libffm parser and sorted-window planner: the host data plane of
// the PyTorch port. A copy of xflow_tpu/native/parser.cc, kept as it is
// (the port imports nothing of xflow_tpu, so it carries its own source);
// only these comments differ. Its batches and plans are bit-identical to
// the JAX package's (tests/test_torch_native.py).
//
// The reference's hot input path is a block-buffered fread parser with
// partial-line carry feeding ragged C++ vectors (the reference's
// src/io/load_data_from_disk.cc:103-210). This parses straight into
// caller-provided fixed-shape buffers (the numpy arrays that are copied
// to the card), so there is no intermediate ragged representation.
//
// Semantics kept in lockstep with data/libffm.py (the Python parser)
// and hashing.py:
//   - label token parsed as double, label = 1 iff > 1e-7
//   - feature token "fgid:fid:value": fgid parsed as number, fid hashed
//     as a *string* with salted FNV-1a 64, value ignored
//   - slot = mix64(hash) & (2^log2_slots - 1), mix64 = xor-shift,
//     multiply by 0xD6E8FEB86659FD93, xor-shift (hashing.py slot_of)
//   - rows longer than max_nnz are truncated (truncation counted)
//
// C ABI (consumed by xflow_tpu_torch/data/native.py via ctypes):
//   xf_hash64(bytes, len, salt) -> uint64
//   xf_parser_open(path, block_bytes) -> handle (NULL on failure)
//   xf_parser_next_batch(handle, batch_size, max_nnz, log2_slots, salt,
//                        slots*, fields*, mask*, labels*, row_mask*)
//       -> rows filled (0 = EOF, -1 = error)
//   xf_parser_truncated(handle) -> truncated-feature count so far
//   xf_parser_close(handle)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;
constexpr uint64_t kMixMul = 0xD6E8FEB86659FD93ULL;

inline uint64_t fnv1a64(const char* data, size_t len, uint64_t salt) {
  uint64_t h = kFnvOffset ^ salt;
  for (size_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= kFnvPrime;
  }
  return h;
}

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 32;
  x *= kMixMul;
  x ^= x >> 32;
  return x;
}

// Field id as int32 with explicit nan→0 and saturation: a raw
// static_cast from an out-of-range double is UB, and the Python path
// (data/libffm.py _fgid_i32) implements these exact semantics.
inline int32_t fgid_i32(double d) {
  if (d != d) return 0;
  if (d >= 2147483647.0) return 2147483647;
  if (d <= -2147483648.0) return INT32_MIN;
  return static_cast<int32_t>(d);
}

// Parse one CR-stripped line into padded row buffers (srow/frow/mrow are
// max_nnz-stride spans, assumed zeroed). Returns true iff the line is a
// row (non-empty with a label separator). Shared by the single-threaded
// and multi-threaded parsers so their outputs are byte-identical.
inline bool parse_row(const char* line, size_t len, long max_nnz,
                      int log2_slots, uint64_t salt, int32_t* srow,
                      int32_t* frow, float* mrow, float* label,
                      long* truncated) {
  // strip surrounding ASCII whitespace exactly like the Python path's
  // line.strip(): a label-only line with trailing spaces is NOT a row
  auto is_ws = [](char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
  };
  while (len > 0 && is_ws(line[len - 1])) --len;
  while (len > 0 && is_ws(line[0])) {
    ++line;
    --len;
  }
  if (len == 0) return false;
  const char* cur = line;
  const char* lend = line + len;
  // label/features separator: the FIRST TAB if the line has one, else the
  // first space — mirroring parse_line's split("\t", 1) -> split(" ", 1)
  const char* tab =
      static_cast<const char*>(memchr(cur, '\t', static_cast<size_t>(len)));
  if (tab == nullptr)
    tab = static_cast<const char*>(memchr(cur, ' ', static_cast<size_t>(len)));
  if (tab == nullptr) return false;  // malformed: no features
  *label = (strtod(cur, nullptr) > 1e-7) ? 1.0f : 0.0f;
  cur = tab + 1;
  long nnz = 0;
  // tokens split on any whitespace, matching the Python path's .split()
  auto is_sep = is_ws;
  while (cur < lend) {
    while (cur < lend && is_sep(*cur)) ++cur;
    if (cur >= lend) break;
    const char* tok_end = cur;
    while (tok_end < lend && !is_sep(*tok_end)) ++tok_end;
    // token = fgid:fid[:value...]; value never parsed (reference
    // behavior: load_data_from_disk.cc:150-153 breaks after fid)
    const char* c1 = static_cast<const char*>(
        memchr(cur, ':', static_cast<size_t>(tok_end - cur)));
    if (c1 != nullptr) {
      const char* c2 = static_cast<const char*>(
          memchr(c1 + 1, ':', static_cast<size_t>(tok_end - c1 - 1)));
      const char* fid_end = (c2 != nullptr) ? c2 : tok_end;
      if (nnz < max_nnz) {
        frow[nnz] = fgid_i32(strtod(cur, nullptr));
        uint64_t key =
            fnv1a64(c1 + 1, static_cast<size_t>(fid_end - c1 - 1), salt);
        srow[nnz] = static_cast<int32_t>(mix64(key) &
                                         ((1ULL << log2_slots) - 1ULL));
        mrow[nnz] = 1.0f;
        ++nnz;
      } else {
        ++*truncated;
      }
    }
    cur = tok_end;
  }
  // rows with zero valid features are kept (mask all-zero), matching the
  // Python path: a labeled line is an example even if its features are
  // unparseable
  return true;
}

struct Parser {
  FILE* fp = nullptr;
  std::vector<char> buf;
  size_t pos = 0;    // next unparsed byte
  size_t end = 0;    // valid bytes in buf
  bool eof = false;
  bool error = false;  // fread failed (ferror), distinct from EOF
  long truncated = 0;

  // Returns [line, line+len) for the next complete line (without the
  // trailing newline) or nullptr at EOF. The pointer is valid until the
  // next call.
  const char* next_line(size_t* len) {
    for (;;) {
      // scan for newline in the unparsed region
      char* nl = static_cast<char*>(memchr(buf.data() + pos, '\n', end - pos));
      if (nl != nullptr) {
        const char* line = buf.data() + pos;
        *len = static_cast<size_t>(nl - line);
        pos = static_cast<size_t>(nl - buf.data()) + 1;
        return line;
      }
      if (eof) {
        if (pos < end) {  // final line without trailing newline
          const char* line = buf.data() + pos;
          *len = end - pos;
          pos = end;
          return line;
        }
        return nullptr;
      }
      // carry the partial line to the front and refill
      size_t carry = end - pos;
      if (carry > 0 && pos > 0) memmove(buf.data(), buf.data() + pos, carry);
      pos = 0;
      end = carry;
      if (end == buf.size()) {
        // a single line longer than the buffer: grow
        buf.resize(buf.size() * 2);
      }
      size_t got = fread(buf.data() + end, 1, buf.size() - end, fp);
      end += got;
      if (got == 0) {
        eof = true;
        if (ferror(fp)) {
          // I/O fault, not end-of-data: discard the buffered partial tail
          // immediately so no data from a failed read ever reaches a batch
          error = true;
          return nullptr;
        }
      }
    }
  }
};

}  // namespace

extern "C" {

uint64_t xf_hash64(const char* data, long len, uint64_t salt) {
  return fnv1a64(data, static_cast<size_t>(len), salt);
}

uint64_t xf_slot(uint64_t key, int log2_slots) {
  return mix64(key) & ((1ULL << log2_slots) - 1ULL);
}

void* xf_parser_open(const char* path, long block_bytes) {
  FILE* fp = fopen(path, "rb");
  if (fp == nullptr) return nullptr;
  Parser* p = new Parser();
  p->fp = fp;
  p->buf.resize(block_bytes > 4096 ? static_cast<size_t>(block_bytes) : 4096);
  return p;
}

long xf_parser_truncated(void* handle) {
  return static_cast<Parser*>(handle)->truncated;
}

// Fills one padded batch. Buffers must be shaped:
//   slots, fields: int32 [batch_size, max_nnz]
//   mask:          float [batch_size, max_nnz]
//   labels, row_mask: float [batch_size]
// and are assumed zero-initialized by the caller.
long xf_parser_next_batch(void* handle, long batch_size, long max_nnz,
                          int log2_slots, uint64_t salt, int32_t* slots,
                          int32_t* fields, float* mask, float* labels,
                          float* row_mask) {
  Parser* p = static_cast<Parser*>(handle);
  long row = 0;
  size_t len = 0;
  while (row < batch_size) {
    const char* line = p->next_line(&len);
    if (line == nullptr) {
      if (p->error) return -1;
      break;
    }
    if (parse_row(line, len, max_nnz, log2_slots, salt, slots + row * max_nnz,
                  fields + row * max_nnz, mask + row * max_nnz, labels + row,
                  &p->truncated)) {
      row_mask[row] = 1.0f;
      ++row;
    }
  }
  return row;
}

void xf_parser_close(void* handle) {
  Parser* p = static_cast<Parser*>(handle);
  if (p->fp != nullptr) fclose(p->fp);
  delete p;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Multi-threaded parser pool.
//
// The reference fans parsing + compute over hardware_concurrency() worker
// threads (its src/base/thread_pool.h:70-86, lr_worker.cc:190-199) with no
// ordering guarantees (hogwild). Here the host data plane feeds a
// synchronous device step, so the design is:
// N workers each parse disjoint ~block_bytes file blocks (newline-aligned)
// into padded row buffers, and a sequencer drains blocks IN FILE ORDER —
// output is byte-identical to the single-threaded parser, keeping training
// deterministic, while hashing/strtod (the actual cost) runs in parallel.
// A bounded window (2x threads) of in-flight blocks caps memory.
// ---------------------------------------------------------------------------

namespace {

struct ParsedBlock {
  long rows = 0;
  std::vector<float> labels;
  std::vector<int32_t> slots, fields;
  std::vector<float> mask;
  long truncated = 0;
  bool error = false;
};

struct MtParser {
  std::string path;
  long block_bytes = 0, max_nnz = 0;
  int log2_slots = 0;
  uint64_t salt = 0;
  long n_blocks = 0;
  long window = 0;  // max blocks a worker may run ahead of the consumer

  std::atomic<long> next_block{0};
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<long, ParsedBlock> ready;
  long consume_idx = 0;  // next block index the consumer needs
  bool shutdown = false;
  std::vector<std::thread> threads;

  // consumer-side cursor
  ParsedBlock cur;
  long cur_row = 0;
  bool failed = false;
  long truncated_total = 0;

  ~MtParser() {
    {
      std::lock_guard<std::mutex> lk(mu);
      shutdown = true;
    }
    cv_space.notify_all();
    for (auto& t : threads) t.join();
  }

  ParsedBlock parse_block(long b) {
    ParsedBlock out;
    FILE* fp = fopen(path.c_str(), "rb");
    if (fp == nullptr) {
      out.error = true;
      return out;
    }
    // Read from one byte before the block so we can tell whether the
    // block boundary falls exactly on a line start (previous byte '\n').
    long base = b * block_bytes - (b > 0 ? 1 : 0);
    if (fseek(fp, base, SEEK_SET) != 0) {
      out.error = true;
      fclose(fp);
      return out;
    }
    std::vector<char> data;
    size_t want = static_cast<size_t>(block_bytes + (b > 0 ? 1 : 0));
    data.resize(want + 4096);
    size_t size = fread(data.data(), 1, data.size(), fp);
    bool eof = size < data.size();
    if (eof && ferror(fp)) {
      out.error = true;
      fclose(fp);
      return out;
    }
    // limit: lines whose first byte lies within this block
    size_t limit = want < size ? want : size;
    size_t pos = 0;
    if (b > 0) {
      if (size == 0) {
        fclose(fp);
        return out;  // past EOF
      }
      if (data[0] != '\n') {
        // mid-line start: the line belongs to the previous block; skip it
        const char* nl =
            static_cast<const char*>(memchr(data.data(), '\n', size));
        if (nl == nullptr) {
          fclose(fp);
          return out;  // a single line spans the whole block
        }
        pos = static_cast<size_t>(nl - data.data()) + 1;
      } else {
        pos = 1;
      }
    }
    while (pos < limit) {
      // ensure the line starting at pos is fully buffered
      const char* nl = static_cast<const char*>(
          memchr(data.data() + pos, '\n', size - pos));
      while (nl == nullptr && !eof) {
        size_t old = size;
        data.resize(data.size() + (64 << 10));
        size_t got = fread(data.data() + old, 1, data.size() - old, fp);
        size += got;
        eof = size < data.size();
        if (eof && ferror(fp)) {
          out.error = true;
          fclose(fp);
          return out;
        }
        nl = static_cast<const char*>(
            memchr(data.data() + old, '\n', size - old));
      }
      size_t line_end = nl ? static_cast<size_t>(nl - data.data()) : size;
      long r = out.rows;
      out.labels.resize(r + 1, 0.0f);
      out.slots.resize((r + 1) * max_nnz, 0);
      out.fields.resize((r + 1) * max_nnz, 0);
      out.mask.resize((r + 1) * max_nnz, 0.0f);
      if (parse_row(data.data() + pos, line_end - pos, max_nnz, log2_slots,
                    salt, out.slots.data() + r * max_nnz,
                    out.fields.data() + r * max_nnz,
                    out.mask.data() + r * max_nnz, out.labels.data() + r,
                    &out.truncated)) {
        out.rows = r + 1;
      }
      if (nl == nullptr) break;  // final unterminated line
      pos = line_end + 1;
    }
    // shrink over-allocated last row if the final line was not a row
    out.labels.resize(out.rows);
    out.slots.resize(out.rows * max_nnz);
    out.fields.resize(out.rows * max_nnz);
    out.mask.resize(out.rows * max_nnz);
    fclose(fp);
    return out;
  }

  void worker() {
    for (;;) {
      long b = next_block.fetch_add(1);
      if (b >= n_blocks) return;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return shutdown || b < consume_idx + window; });
        if (shutdown) return;
      }
      ParsedBlock blk = parse_block(b);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace(b, std::move(blk));
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* xf_mt_open(const char* path, long block_bytes, int threads, long max_nnz,
                 int log2_slots, uint64_t salt) {
  FILE* fp = fopen(path, "rb");
  if (fp == nullptr) return nullptr;
  fseek(fp, 0, SEEK_END);
  long fsize = ftell(fp);
  fclose(fp);
  if (fsize < 0) return nullptr;
  MtParser* p = new MtParser();
  p->path = path;
  p->block_bytes = block_bytes > 4096 ? block_bytes : 4096;
  p->max_nnz = max_nnz;
  p->log2_slots = log2_slots;
  p->salt = salt;
  p->n_blocks = (fsize + p->block_bytes - 1) / p->block_bytes;
  if (threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    threads = hw > 0 ? static_cast<int>(hw) : 4;
  }
  if (threads > 16) threads = 16;
  if (static_cast<long>(threads) > p->n_blocks && p->n_blocks > 0)
    threads = static_cast<int>(p->n_blocks);
  if (threads < 1) threads = 1;
  p->window = 2L * threads;
  for (int i = 0; i < threads; ++i)
    p->threads.emplace_back(&MtParser::worker, p);
  return p;
}

long xf_mt_truncated(void* handle) {
  return static_cast<MtParser*>(handle)->truncated_total;
}

// Same output contract as xf_parser_next_batch (buffers zero-initialized
// by the caller); parse parameters were fixed at xf_mt_open.
long xf_mt_next_batch(void* handle, long batch_size, int32_t* slots,
                      int32_t* fields, float* mask, float* labels,
                      float* row_mask) {
  MtParser* p = static_cast<MtParser*>(handle);
  if (p->failed) return -1;
  long row = 0;
  long nnz = p->max_nnz;
  while (row < batch_size) {
    if (p->cur_row >= p->cur.rows) {
      // current block exhausted: pull the next one, in file order
      std::unique_lock<std::mutex> lk(p->mu);
      if (p->consume_idx >= p->n_blocks) break;  // all input consumed
      long want = p->consume_idx;
      p->cv_ready.wait(lk, [&] { return p->ready.count(want) != 0; });
      p->cur = std::move(p->ready[want]);
      p->ready.erase(want);
      p->consume_idx = want + 1;
      p->truncated_total += p->cur.truncated;
      p->cur_row = 0;
      lk.unlock();
      p->cv_space.notify_all();
      if (p->cur.error) {
        p->failed = true;
        return -1;
      }
      continue;
    }
    long take = batch_size - row;
    long avail = p->cur.rows - p->cur_row;
    if (take > avail) take = avail;
    memcpy(labels + row, p->cur.labels.data() + p->cur_row,
           take * sizeof(float));
    memcpy(slots + row * nnz, p->cur.slots.data() + p->cur_row * nnz,
           take * nnz * sizeof(int32_t));
    memcpy(fields + row * nnz, p->cur.fields.data() + p->cur_row * nnz,
           take * nnz * sizeof(int32_t));
    memcpy(mask + row * nnz, p->cur.mask.data() + p->cur_row * nnz,
           take * nnz * sizeof(float));
    for (long i = 0; i < take; ++i) row_mask[row + i] = 1.0f;
    row += take;
    p->cur_row += take;
  }
  return row;
}

void xf_mt_close(void* handle) { delete static_cast<MtParser*>(handle); }

// Count the rows xf_parser_next_batch would produce for this file — the
// EXACT same line predicate (CR-stripped non-empty line containing a
// label separator), no hashing or token parsing. Used to precompute
// per-epoch batch counts so multi-process training needs ONE collective
// per epoch instead of one per step. Returns -1 on open/read failure.
long xf_count_rows(const char* path, long block_bytes) {
  void* handle = xf_parser_open(path, block_bytes);
  if (handle == nullptr) return -1;
  Parser* p = static_cast<Parser*>(handle);
  long rows = 0;
  size_t len = 0;
  auto is_ws = [](char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
  };
  for (;;) {
    const char* line = p->next_line(&len);
    if (line == nullptr) break;
    // same strip as parse_row: a row iff the STRIPPED line still contains
    // a label separator (tab or space)
    while (len > 0 && is_ws(line[len - 1])) --len;
    while (len > 0 && is_ws(line[0])) {
      ++line;
      --len;
    }
    if (len == 0) continue;
    if (memchr(line, '\t', len) != nullptr || memchr(line, ' ', len) != nullptr) {
      ++rows;
    }
  }
  bool err = p->error;
  xf_parser_close(handle);
  return err ? -1 : rows;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sorted-window planner (ops/sorted_table.py host side).
//
// Stable LSD radix sort of a batch's feature occurrences by table slot,
// emitting the padded arrays the sorted-window kernels consume.
// np.argsort(kind="stable") on 1.2M occurrences took 167 ms a batch on
// the H100's host (PERF.md) — enough to wall the host data plane at the
// card's step times; this radix sort is O(n) per 11-bit digit (2 passes at
// log2_slots <= 22).
//
// Output contract matches plan_sorted_batch exactly (parity-tested):
//   - out arrays have np_len entries; pads carry slot num_slots-1,
//     row/field 0, mask 0
//   - out_win_off[w] = first sorted position with slot >= w*window,
//     w in [0, num_slots/window]; pads are owned by the last window
//   - stability: equal slots keep original (row-major) occurrence order
//   - the return value is the number of distinct slots among the n
//     unpadded occurrences (the pads are no table rows), counted while
//     the sorted slots are placed: each run's start adds one; -1 (and
//     -2 for the wire contract) on invalid input

namespace {

// PAIR-ENCODED LSD radix: each element
// is one uint64 (slot << 32 | original index), sorted by the slot
// digits only. The index-array variant did an indirect slots[cur[i]]
// load per element per pass — a cache-hostile random read through the
// permutation; here every pass streams the key array sequentially.
// Stability: LSD passes are stable and the index rides in the low
// bits, so equal slots keep their original order — bit-identical
// output to the numpy argsort(kind='stable') planner (parity-tested).
// Returns the sorted key pointer (into keys or scratch), or nullptr on
// invalid input — validation lives here so both emitters share it.
uint64_t* plan_sort_core(const int32_t* slots, long n, long nnz_per_row,
                         long num_slots, long window, long np_len,
                         std::vector<uint64_t>& keys,
                         std::vector<uint64_t>& scratch) {
  if (n < 0 || np_len < n || nnz_per_row <= 0 || num_slots <= 0 ||
      window <= 0 || num_slots % window != 0) {
    return nullptr;
  }
  // validate slot range up front: the radix sort masks each 11-bit digit,
  // so an out-of-range slot would otherwise be silently aliased into a
  // wrong window (and its gradient scattered to a wrong table row) —
  // loud failure matches this function's convention
  for (long i = 0; i < n; ++i) {
    if (slots[i] < 0 || slots[i] >= num_slots) return nullptr;
  }
  if (n == 0) {
    // nullptr is this function's ERROR sentinel, and vector::data() on
    // an empty vector may legally return nullptr — hand back a valid
    // pointer the (empty) emission loop never dereferences, so a
    // zero-row batch produces an all-pad plan like the numpy path
    keys.resize(1);
    return keys.data();
  }
  constexpr int kDigitBits = 11;
  constexpr int kRadix = 1 << kDigitBits;
  keys.resize(n);
  scratch.resize(n);
  for (long i = 0; i < n; ++i) {
    keys[i] = (static_cast<uint64_t>(static_cast<uint32_t>(slots[i])) << 32) |
              static_cast<uint32_t>(i);
  }
  int bits = 0;
  while ((1L << bits) < num_slots) ++bits;
  uint64_t* cur = keys.data();
  uint64_t* nxt = scratch.data();
  long hist[kRadix + 1];
  for (int shift = 32; shift < 32 + bits; shift += kDigitBits) {
    memset(hist, 0, sizeof(hist));
    for (long i = 0; i < n; ++i) {
      ++hist[(cur[i] >> shift) & (kRadix - 1)];
    }
    long sum = 0;
    for (int d = 0; d < kRadix; ++d) {
      long c = hist[d];
      hist[d] = sum;
      sum += c;
    }
    for (long i = 0; i < n; ++i) {
      uint64_t k = cur[i];
      nxt[hist[(k >> shift) & (kRadix - 1)]++] = k;
    }
    uint64_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

void plan_win_off(const int32_t* out_slots, long np_len, long num_slots,
                  long window, int32_t* out_win_off) {
  // win_off by linear scan over the sorted (padded) slots
  long n_win = num_slots / window;
  long pos = 0;
  out_win_off[0] = 0;
  for (long w = 1; w <= n_win; ++w) {
    long bound = w * window;
    while (pos < np_len && out_slots[pos] < bound) ++pos;
    out_win_off[w] = static_cast<int32_t>(pos);
  }
}

}  // namespace

extern "C" {

long xf_plan_sorted(const int32_t* slots, const float* mask, const int32_t* fields,
                    long n, long nnz_per_row, long num_slots, long window,
                    long np_len, int32_t* out_slots, int32_t* out_row,
                    float* out_mask, int32_t* out_fields, int32_t* out_win_off) {
  std::vector<uint64_t> keys, scratch;
  uint64_t* cur =
      plan_sort_core(slots, n, nnz_per_row, num_slots, window, np_len, keys, scratch);
  if (cur == nullptr) return -1;
  long distinct = 0;
  for (long i = 0; i < n; ++i) {
    uint64_t k = cur[i];
    int32_t src = static_cast<int32_t>(k & 0xffffffffu);
    out_slots[i] = static_cast<int32_t>(k >> 32);
    distinct += (i == 0 || out_slots[i] != out_slots[i - 1]);
    out_row[i] = static_cast<int32_t>(src / nnz_per_row);
    out_mask[i] = mask[src];
    if (out_fields != nullptr) out_fields[i] = fields[src];
  }
  for (long i = n; i < np_len; ++i) {
    out_slots[i] = static_cast<int32_t>(num_slots - 1);
    out_row[i] = 0;
    out_mask[i] = 0.0f;
    if (out_fields != nullptr) out_fields[i] = 0;
  }
  plan_win_off(out_slots, np_len, num_slots, window, out_win_off);
  return distinct;
}

// Wire-format emitter (ops/sorted_table.compact_plan_wire's dtypes
// produced DIRECTLY): uint16 row ids, uint8 0/1 mask, uint8 fields —
// the numpy intermediate plus three astype passes per batch disappear
// from the host budget. The caller guarantees the bounds from CONFIG
// (rows <= 2^16, fields < 2^8 — never from data, the multi-process
// rank-symmetry rule); a violated bound or a non-0/1 mask returns -2
// (distinct from -1 = malformed plan input) so the Python wrapper can
// name the actual contract broken.
long xf_plan_sorted_wire(const int32_t* slots, const float* mask,
                         const int32_t* fields, long n, long nnz_per_row,
                         long num_slots, long window, long np_len,
                         int32_t* out_slots, uint16_t* out_row,
                         uint8_t* out_mask, uint8_t* out_fields,
                         int32_t* out_win_off) {
  std::vector<uint64_t> keys, scratch;
  uint64_t* cur =
      plan_sort_core(slots, n, nnz_per_row, num_slots, window, np_len, keys, scratch);
  if (cur == nullptr) return -1;
  long distinct = 0;
  for (long i = 0; i < n; ++i) {
    uint64_t k = cur[i];
    int32_t src = static_cast<int32_t>(k & 0xffffffffu);
    long row = src / nnz_per_row;
    float m = mask[src];
    if (row >= (1L << 16) || (m != 0.0f && m != 1.0f)) return -2;
    out_slots[i] = static_cast<int32_t>(k >> 32);
    distinct += (i == 0 || out_slots[i] != out_slots[i - 1]);
    out_row[i] = static_cast<uint16_t>(row);
    out_mask[i] = static_cast<uint8_t>(m != 0.0f);
    if (out_fields != nullptr) {
      int32_t f = fields[src];
      if (f < 0 || f >= (1 << 8)) return -2;
      out_fields[i] = static_cast<uint8_t>(f);
    }
  }
  for (long i = n; i < np_len; ++i) {
    out_slots[i] = static_cast<int32_t>(num_slots - 1);
    out_row[i] = 0;
    out_mask[i] = 0;
    if (out_fields != nullptr) out_fields[i] = 0;
  }
  plan_win_off(out_slots, np_len, num_slots, window, out_win_off);
  return distinct;
}

}  // extern "C"
