// Fused predicate-filter + aggregate table scans for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of the read path:
//   K1  src/repro/kernels/batched_filter_agg.py:163  batched_filter_agg
//       (kernel body _batched_kernel)   -> batched_filter_agg_launch
//   K4  src/repro/kernels/batched_filter_agg.py:308
//       sharded_batched_filter_agg
//       (kernel body _sharded_kernel)   -> sharded_filter_agg_launch
//   K2  src/repro/kernels/filter_agg.py:103          filter_agg
//       (kernel body _filter_agg_kernel) -> filter_agg_launch
//   K3  src/repro/kernels/batched_filter_agg.py:483
//       sharded_batched_filter_agg_masked
//       (kernel body _masked_sharded_kernel) -> masked_filter_agg_launch
//
// Semantics (src/repro/kernels/ref.py): for each query q, SUM(agg) and
// COUNT(*) over the rows with
//   lo0[q] <= pred0 <= hi0[q]  and  lo1[q] <= pred1 <= hi1[q]
//   and begin_ts <= ts[q] < end_ts  and  page >= start_page[q],
// both wrapping like int32.  Partial sums are uint32 (signed overflow
// is undefined in C++; unsigned addition wraps and commutes), reduced
// per warp with shuffles and per block in shared memory, then added to
// the (B,) output with atomicAdd, so the result does not depend on the
// order in which blocks run.
//
// K1 and K4 share one stream path (stream_filter_agg_kernel); K1 is
// its S = 1 case: one shard of n_pages pages, all of them real, a
// (1, B) table of start pages.  What bounds it on the H100 is bytes:
// per row it reads five int32 values (two predicate planes, the
// aggregate plane, begin_ts, end_ts) and does about nine integer
// operations per query, so up to B ~ 12 the floor is the HBM stream
// (3.35 TB/s) and above that the int32 issue rate.  The port stores
// its tables attribute-major (core/table.py), so every plane is a
// unit-stride run of int32 and a tile of rows is one contiguous run
// per plane.  The design answers the bound four ways:
//   * Unit-stride 16-byte streams.  Neighbouring lanes load
//     neighbouring 16-byte words of each plane.  Bytes in flight come
//     from registers, not a shared-memory ring: each thread issues
//     kVecs 16-byte loads per plane (5 x kVecs x 16 = 320 bytes) before
//     it evaluates a query, and two 256-thread blocks share an SM, so
//     about 160 KB per SM are in flight, well above what the HBM
//     latency asks for.  A TMA ring (cp.async.bulk into shared memory,
//     mbarrier completion) would move the same bytes and then cost the
//     consumer warps a shared-memory read per value; registers keep the
//     values where the compares use them, and the plain loads need no
//     16-byte alignment of the live range.  Rows of a 16-byte word that
//     lie outside the tile's live rows (pages that are not a multiple
//     of 16 bytes, a live range that starts mid-word) are loaded one by
//     one inside the bounds; planes whose base addresses differ modulo
//     16 bytes (an offset view) are loaded one row at a time.
//   * A persistent grid over live tiles only.  The grid is sized to the
//     card, min(live-tile upper bound, blocks per SM x SMs); each block
//     derives every shard's live row range on the device, [min_q
//     start[s, q], local_pages[s]) in pages, and walks the flat list of
//     live tiles with a stride of gridDim.x.  No block is spent on
//     prefix or padding tiles (the TPU kernel's clamped block window),
//     and a launch whose starts all lie past local_pages loads no row.
//   * Per-query partials stay in shared memory across all of a block's
//     tiles: one atomicAdd per (block, query), not one per tile.
//   * The page test runs only in the tile that straddles a query's
//     start, as a row compare; tiles wholly past the start skip it,
//     tiles wholly before it skip the query.  Per (row, query) the rest
//     is four compares and two adds: each range test is one unsigned
//     compare, and the match is combined bitwise, so the compiler keeps
//     it in chained predicates.  That keeps the work near nine
//     operations per (row, query), under the byte stream up to B ~ 12.
// Queries are taken in chunks of kQueryChunk whose bounds sit in shared
// memory; a batch larger than that streams its rows once per chunk.
//
// K3 runs the stream path's loads and compares over the pages that a
// coverage bitmap leaves open, on S stacked shards.  What bounds it is
// bytes again, now those of the open pages only (five int32 planes per
// open row, plus one 4-byte coverage word per 32 pages), up to B ~ 12.
// Its design:
//   * A persistent grid over coverage words.  The work items are the
//     words of every shard, flat over S x ceil(n_pages / 32); the grid
//     fills the card and block b takes items b, b + gridDim.x, ...  A
//     warp pulls 32 of its items at once: each lane loads one word,
//     ORs in the bits of pages at or past min(local_pages[s], n_pages)
//     (a word wholly past them is not loaded at all, so no word at or
//     past W is read), and the open pages (~word) are listed in a
//     shared-memory ring with __popc over a warp scan.  A word that is
//     all ones costs its 4-byte load and no row.
//   * Open pages, not masked lanes.  A step streams kStepWords 16-byte
//     words of the pending open pages (about kStepRows rows), each
//     page as the run of 16-byte words from the one holding its first
//     row, with the stream path's load_word: int4 loads inside the
//     page, row by row at its edges (page sizes that are not a
//     multiple of 4, planes that start mid-word) and where the planes
//     disagree modulo 16 bytes.  A block pulls again only when less
//     than a step is pending, so small pages fill a step from many
//     words.  Per 16-byte word the address costs one 32-bit division
//     (word -> ring page); there is no page or coverage test per row.
//   * The stream path's query side: stage_query / row_match, queries
//     in kQueryChunk chunks in shared memory, per-query partials in
//     shared memory across all of a block's items and one atomicAdd
//     per (block, query, chunk).
//
// K2 keeps the first port's tile body (scan_tile): one block per tile
// of whole pages, one row per thread and load, unit-stride planes as
// for the stream path, so its loads coalesce.  It is the single-query
// scan with its bounds passed by value; the tests hold it equal to a
// one-query K1 batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kQueryChunk = 64;

struct Planes {
  const int32_t* pred0;
  const int32_t* pred1;
  const int32_t* agg;
  const int32_t* begin_ts;
  const int32_t* end_ts;
  long long n_rows;  // n_pages * page_size
  int page_size;
  int tile_rows;  // rows per block: block_pages * page_size
};

struct Bounds {
  int lo0, hi0, lo1, hi1, ts, start_page;
};

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// K2's tile body: scan rows [row0, row_end) for the nq <= kQueryChunk
// queries whose bounds are staged in shared memory, and add the block's
// partial sums into out_sum[0:nq] / out_cnt[0:nq].  Every thread of the
// block must call it: the loops below are uniform across the block, so
// the warp shuffles always see full warps.
__device__ void scan_tile(const Planes& p, const Bounds* qs, int nq,
                          long long row0, long long row_end,
                          unsigned* out_sum, unsigned* out_cnt) {
  __shared__ unsigned acc_sum[kWarps][kQueryChunk];
  __shared__ unsigned acc_cnt[kWarps][kQueryChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int last_page = (int)((row_end - 1) / p.page_size);

  for (int i = threadIdx.x; i < kWarps * kQueryChunk; i += kThreads) {
    (&acc_sum[0][0])[i] = 0u;
    (&acc_cnt[0][0])[i] = 0u;
  }
  __syncthreads();

  for (long long base = row0; base < row_end;
       base += (long long)kThreads * kRowsPerThread) {
    int v0[kRowsPerThread], v1[kRowsPerThread], va[kRowsPerThread];
    int bt[kRowsPerThread], et[kRowsPerThread], pg[kRowsPerThread];
    bool live[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const long long r = base + (long long)k * kThreads + threadIdx.x;
      live[k] = r < row_end;
      if (live[k]) {
        v0[k] = p.pred0[r];
        v1[k] = p.pred1[r];
        va[k] = p.agg[r];
        bt[k] = p.begin_ts[r];
        et[k] = p.end_ts[r];
        pg[k] = (int)(r / p.page_size);
      } else {
        v0[k] = v1[k] = va[k] = bt[k] = et[k] = pg[k] = 0;
      }
    }
    for (int q = 0; q < nq; ++q) {
      const Bounds b = qs[q];
      if (last_page < b.start_page) continue;  // uniform across the block
      unsigned s = 0u, c = 0u;
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const bool m = live[k] && v0[k] >= b.lo0 && v0[k] <= b.hi0 &&
                       v1[k] >= b.lo1 && v1[k] <= b.hi1 && bt[k] <= b.ts &&
                       b.ts < et[k] && pg[k] >= b.start_page;
        s += m ? (unsigned)va[k] : 0u;
        c += m ? 1u : 0u;
      }
      s = warp_sum(s);
      c = warp_sum(c);
      if (lane == 0) {
        acc_sum[warp][q] += s;
        acc_cnt[warp][q] += c;
      }
    }
  }
  __syncthreads();

  for (int q = threadIdx.x; q < nq; q += kThreads) {
    unsigned s = 0u, c = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += acc_sum[w][q];
      c += acc_cnt[w][q];
    }
    if (c != 0u) {  // no match in this tile adds nothing
      atomicAdd(out_sum + q, s);
      atomicAdd(out_cnt + q, c);
    }
  }
  __syncthreads();  // the caller may restage qs / reuse the accumulators
}

// K2: the same tile body for one query passed by value.
__global__ void __launch_bounds__(kThreads)
filter_agg_kernel(Planes p, Bounds b, unsigned* out_sum, unsigned* out_cnt) {
  __shared__ Bounds qs[1];
  const long long row0 = (long long)blockIdx.x * p.tile_rows;
  const long long row_end =
      row0 + p.tile_rows < p.n_rows ? row0 + p.tile_rows : p.n_rows;
  const int last_page = (int)((row_end - 1) / p.page_size);
  if (last_page < b.start_page) return;  // inside the indexed prefix
  if (threadIdx.x == 0) qs[0] = b;
  __syncthreads();
  scan_tile(p, qs, 1, row0, row_end, out_sum, out_cnt);
}

// ---------------------------------------------------------------------
// K1 / K4: the stream path (notes at the top of the file).

constexpr int kVecs = 4;  // 16-byte words per thread per plane per step
constexpr int kStepRows = kThreads * 4 * kVecs;  // 4,096 rows per step
constexpr int kMaxShards = 1024;  // the shard table lives in shared memory

// Five unit-stride planes over S stacked shards of shard_rows rows.
// Rows are addressed as R = row + off: in the 16-byte mode every plane
// has the same address modulo 16, so plane[i] - off is 16-byte aligned
// and a word holds the four rows whose R / 4 agree.
struct Stream {
  const int32_t* plane[5];  // pred0, pred1, agg, begin_ts, end_ts
  long long shard_rows;     // n_pages * page_size
  int n_shards;
  int n_pages;
  int page_size;
  int tile_rows;  // rows per tile of the live-tile list, a multiple of 4
  int off;        // 0 unless vec
  bool vec;       // the planes agree modulo 16 bytes: 16-byte loads
};

// A query staged for the stream path: lo <= x <= hi becomes the one
// unsigned compare (unsigned)(x - lo) <= hi - lo (exact when lo <= hi;
// a query with lo > hi matches nothing and is not live).
struct Query {
  int lo0, lo1, ts;
  unsigned w0, w1;
  bool live;
};

__device__ __forceinline__ Query stage_query(int lo0, int hi0, int lo1,
                                             int hi1, int ts) {
  return Query{lo0, lo1, ts, (unsigned)hi0 - (unsigned)lo0,
               (unsigned)hi1 - (unsigned)lo1, lo0 <= hi0 && lo1 <= hi1};
}

// Rows R0 .. R0 + 3 of every plane into v[plane][k].  Rows outside the
// live range [a, b) are not read; they get end_ts = INT32_MIN, which no
// snapshot satisfies (ts < end_ts), so they match no query.
__device__ __forceinline__ void load_word(const Stream& p, long long R0,
                                          long long a, long long b,
                                          int (&v)[5][4]) {
  if (p.vec && R0 >= a && R0 + 4 <= b) {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int4 w =
          __ldg(reinterpret_cast<const int4*>(p.plane[i] - p.off + R0));
      v[i][0] = w.x;
      v[i][1] = w.y;
      v[i][2] = w.z;
      v[i][3] = w.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long R = R0 + k;
    const bool in = R >= a && R < b;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      v[i][k] = in ? __ldg(p.plane[i] + (R - p.off)) : 0;
    }
    if (!in) v[4][k] = INT32_MIN;
  }
}

// 1 if row k of the word matches q, else 0.  Bitwise, not
// short-circuit: the compiler then chains predicates instead of
// materialising each compare as a byte.
__device__ __forceinline__ unsigned row_match(const Query& q,
                                              const int (&v)[5][4], int k) {
  return (unsigned)((unsigned)v[0][k] - (unsigned)q.lo0 <= q.w0) &
         (unsigned)((unsigned)v[1][k] - (unsigned)q.lo1 <= q.w1) &
         (unsigned)(v[3][k] <= q.ts) & (unsigned)(q.ts < v[4][k]);
}

// Adds the matches of query Q among every row of v to (s, c).
__device__ __forceinline__ void add_matches(const Query& Q,
                                            const int (&v)[kVecs][5][4],
                                            unsigned& s, unsigned& c) {
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned m = row_match(Q, v[j], k);
      s += (unsigned)v[j][2][k] & (0u - m);
      c += m;
    }
  }
}

// One tile of the live-tile list: rows [a, b) of the tile that starts
// at R = tile0, in steps of kStepRows.  q_start[q] is the first row (R)
// that query q counts in the current shard.  Every thread of the block
// runs it: its branches are uniform, so the shuffles see full warps.
__device__ __forceinline__ void stream_tile(
    const Stream& p, const Query* qs, const long long* q_start, int nq,
    long long tile0, long long a, long long b,
    unsigned (*acc_sum)[kQueryChunk], unsigned (*acc_cnt)[kQueryChunk]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (long long step = tile0; step < b; step += kStepRows) {
    if (step + kStepRows <= a) continue;
    int v[kVecs][5][4];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      load_word(p, step + (long long)(j * kThreads + threadIdx.x) * 4, a, b,
                v[j]);
    }
    for (int q = 0; q < nq; ++q) {
      const long long qa = q_start[q];
      if (qa >= b) continue;  // the query starts past this tile
      const Query Q = qs[q];
      if (!Q.live) continue;  // an empty range matches nothing
      unsigned s = 0u, c = 0u;
      if (qa <= a || qa <= step) {  // every loaded row is past its start
        add_matches(Q, v, s, c);
      } else {  // the tile straddles the query's start: test each row
        const long long d = qa - step;
        const int lim = d > kStepRows ? kStepRows : (int)d;
#pragma unroll
        for (int j = 0; j < kVecs; ++j) {
          const int rel = (j * kThreads + threadIdx.x) * 4;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const unsigned m =
                (unsigned)(rel + k >= lim) & row_match(Q, v[j], k);
            s += (unsigned)v[j][2][k] & (0u - m);
            c += m;
          }
        }
      }
      s = warp_sum(s);
      c = warp_sum(c);
      if (lane == 0) {
        acc_sum[warp][q] += s;
        acc_cnt[warp][q] += c;
      }
    }
  }
}

__device__ __forceinline__ int clamp_pages(int x, int n) {
  return x < 0 ? 0 : (x > n ? n : x);
}

// start_pages is (S, nq), each (shard, query) pair's LOCAL start page;
// a row of shard s, local page pg counts for query q iff start_pages[s,
// q] <= pg < local_pages[s] (local_pages == nullptr: every page real).
__global__ void __launch_bounds__(kThreads, 2)
stream_filter_agg_kernel(Stream p, const int32_t* __restrict__ lo0,
                         const int32_t* __restrict__ hi0,
                         const int32_t* __restrict__ lo1,
                         const int32_t* __restrict__ hi1,
                         const int32_t* __restrict__ ts,
                         const int32_t* __restrict__ start_pages, int nq,
                         const int32_t* __restrict__ local_pages,
                         unsigned* out_sum, unsigned* out_cnt) {
  // The shard table: flat index of each shard's first live tile (and
  // the total at [S]), its live rows [live_lo, live_hi) in R, and the
  // chunk's smallest start page.
  extern __shared__ long long shard_tab[];
  const int S = p.n_shards;
  long long* first = shard_tab;
  long long* live_lo = first + S + 1;
  long long* live_hi = live_lo + S;
  int* min_start = reinterpret_cast<int*>(live_hi + S);
  __shared__ Query qs[kQueryChunk];
  __shared__ long long q_start[kQueryChunk];
  __shared__ unsigned acc_sum[kWarps][kQueryChunk];
  __shared__ unsigned acc_cnt[kWarps][kQueryChunk];
  const long long T = p.tile_rows;

  for (int qc = 0; qc < nq; qc += kQueryChunk) {
    const int n = nq - qc < kQueryChunk ? nq - qc : kQueryChunk;
    for (int i = threadIdx.x; i < S; i += kThreads) min_start[i] = INT32_MAX;
    for (int i = threadIdx.x; i < kWarps * kQueryChunk; i += kThreads) {
      (&acc_sum[0][0])[i] = 0u;
      (&acc_cnt[0][0])[i] = 0u;
    }
    for (int q = threadIdx.x; q < n; q += kThreads) {
      qs[q] = stage_query(lo0[qc + q], hi0[qc + q], lo1[qc + q], hi1[qc + q],
                          ts[qc + q]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < S * n; i += kThreads) {
      const int s = i / n;
      atomicMin(&min_start[s], start_pages[(long long)s * nq + qc + i - s * n]);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      long long total = 0;
      for (int s = 0; s < S; ++s) {
        const int lp = clamp_pages(local_pages ? local_pages[s] : p.n_pages,
                                   p.n_pages);
        const int st = clamp_pages(min_start[s], p.n_pages);
        const long long base = (long long)s * p.shard_rows + p.off;
        const long long lo = base + (long long)st * p.page_size;
        const long long hi = base + (long long)lp * p.page_size;
        first[s] = total;
        live_lo[s] = lo;
        live_hi[s] = hi;
        if (lo < hi) total += (hi - 1) / T - lo / T + 1;
      }
      first[S] = total;
    }
    __syncthreads();

    const long long total = first[S];
    int s = 0, staged = -1;
    for (long long f = blockIdx.x; f < total; f += gridDim.x) {
      while (first[s + 1] <= f) ++s;  // shards with no live tile skip
      if (s != staged) {  // stage the queries' first rows in shard s
        __syncthreads();
        for (int q = threadIdx.x; q < n; q += kThreads) {
          const int st = clamp_pages(start_pages[(long long)s * nq + qc + q],
                                     p.n_pages);
          q_start[q] = (long long)s * p.shard_rows + p.off +
                       (long long)st * p.page_size;
        }
        __syncthreads();
        staged = s;
      }
      const long long tile0 = (live_lo[s] / T + (f - first[s])) * T;
      const long long a = tile0 > live_lo[s] ? tile0 : live_lo[s];
      const long long b = tile0 + T < live_hi[s] ? tile0 + T : live_hi[s];
      stream_tile(p, qs, q_start, n, tile0, a, b, acc_sum, acc_cnt);
    }
    __syncthreads();

    for (int q = threadIdx.x; q < n; q += kThreads) {
      unsigned sum = 0u, cnt = 0u;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sum += acc_sum[w][q];
        cnt += acc_cnt[w][q];
      }
      if (cnt != 0u) {  // no match in this block adds nothing
        atomicAdd(out_sum + qc + q, sum);
        atomicAdd(out_cnt + qc + q, cnt);
      }
    }
    __syncthreads();  // the next chunk restages the shared arrays
  }
}

// ---------------------------------------------------------------------
// K3: the stream path over the pages a coverage bitmap leaves open
// (notes at the top of the file).

constexpr int kPull = 32;  // coverage words a block pulls at once: a warp
// The open-page ring, in pages (a power of two).  A block pulls only
// while less than a step is pending, so at most 1,024 pages are pending
// then, and a pull adds at most kPull * 32 = 1,024.
constexpr int kRing = 2048;
constexpr int kStepWords = kThreads * kVecs;  // 16-byte words per step

// Open pages are streamed page by page: a page spans at most
// page_words 16-byte words of R, from the word holding its first row.
struct Masked {
  Stream p;
  const uint32_t* words;       // (S, n_words) coverage words
  const int32_t* local_pages;  // (S,) real pages per shard
  int n_words;
  int shard_words;  // work items per shard: ceil(n_pages / 32)
  unsigned page_words;
};

__global__ void __launch_bounds__(kThreads, 2)
masked_filter_agg_kernel(Masked m, const int32_t* __restrict__ lo0,
                         const int32_t* __restrict__ hi0,
                         const int32_t* __restrict__ lo1,
                         const int32_t* __restrict__ hi1,
                         const int32_t* __restrict__ ts, int nq,
                         unsigned* out_sum, unsigned* out_cnt) {
  // Open pages as stacked page ids (s * n_pages + page), at positions
  // [head, tail) mod kRing; the head page's first `skip` words are done.
  __shared__ int ring[kRing];
  __shared__ uint32_t pull_open[kPull];
  __shared__ int pull_page[kPull];     // stacked id of each word's page 0
  __shared__ int pull_pos[kPull + 1];  // ring offset of each word's pages
  __shared__ Query qs[kQueryChunk];
  __shared__ unsigned acc_sum[kWarps][kQueryChunk];
  __shared__ unsigned acc_cnt[kWarps][kQueryChunk];
  const Stream& p = m.p;
  const long long n_items = (long long)p.n_shards * m.shard_words;
  const long long stride = (long long)gridDim.x * kPull;
  const unsigned wpp = m.page_words;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int qc = 0; qc < nq; qc += kQueryChunk) {
    const int n = nq - qc < kQueryChunk ? nq - qc : kQueryChunk;
    for (int i = threadIdx.x; i < kWarps * kQueryChunk; i += kThreads) {
      (&acc_sum[0][0])[i] = 0u;
      (&acc_cnt[0][0])[i] = 0u;
    }
    for (int q = threadIdx.x; q < n; q += kThreads) {
      qs[q] = stage_query(lo0[qc + q], hi0[qc + q], lo1[qc + q], hi1[qc + q],
                          ts[qc + q]);
    }
    __syncthreads();

    long long next = blockIdx.x;  // this block's next work item
    unsigned head = 0, tail = 0, skip = 0;
    for (;;) {
      // Pull coverage words until a step's words are pending or the
      // block's items run out; each block takes every gridDim.x-th word.
      while ((long long)(tail - head) * wpp - skip < kStepWords &&
             next < n_items) {
        if (warp == 0) {
          const long long f = next + (long long)lane * gridDim.x;
          uint32_t open = 0u;
          int page0 = 0;
          if (f < n_items) {  // fewer than 2^31 items (the launch checks)
            const int s = (int)f / m.shard_words;
            const int w = (int)f - s * m.shard_words;
            const int live = clamp_pages(m.local_pages[s], p.n_pages) - w * 32;
            if (live > 0) {  // words wholly past the real pages: no load
              open = ~__ldg(m.words + (long long)s * m.n_words + w);
              if (live < 32) open &= (1u << live) - 1u;
            }
            page0 = s * p.n_pages + w * 32;
          }
          const int c = __popc(open);
          int incl = c;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += t;
          }
          pull_open[lane] = open;
          pull_page[lane] = page0;
          pull_pos[lane] = incl - c;
          if (lane == 31) pull_pos[kPull] = incl;
        }
        __syncthreads();  // also: the last step's ring reads are done
        for (int i = threadIdx.x; i < kPull * 32; i += kThreads) {
          const uint32_t open = pull_open[i >> 5];
          const int b = i & 31;
          if ((open >> b) & 1u) {
            const int pos = pull_pos[i >> 5] + __popc(open & ((1u << b) - 1u));
            ring[(tail + pos) & (kRing - 1)] = pull_page[i >> 5] + b;
          }
        }
        tail += pull_pos[kPull];
        next += stride;
        __syncthreads();
      }
      const long long pending = (long long)(tail - head) * wpp - skip;
      if (pending <= 0) break;
      const unsigned nw =
          pending < kStepWords ? (unsigned)pending : (unsigned)kStepWords;

      // One step: word x of the pending run lies in ring page x / wpp.
      int v[kVecs][5][4];
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const unsigned x = (unsigned)(j * kThreads) + threadIdx.x;
        if (x < nw) {
          const unsigned k = (skip + x) / wpp;
          const unsigned i = skip + x - k * wpp;
          const long long a =
              (long long)ring[(head + k) & (kRing - 1)] * p.page_size + p.off;
          load_word(p, (a & ~3LL) + 4LL * i, a, a + p.page_size, v[j]);
        } else {  // past the pending words: no row
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[j][0][k] = v[j][1][k] = v[j][2][k] = v[j][3][k] = 0;
            v[j][4][k] = INT32_MIN;
          }
        }
      }
      for (int q = 0; q < n; ++q) {
        const Query Q = qs[q];
        if (!Q.live) continue;  // an empty range matches nothing
        unsigned s = 0u, c = 0u;
        add_matches(Q, v, s, c);
        s = warp_sum(s);
        c = warp_sum(c);
        if (lane == 0) {
          acc_sum[warp][q] += s;
          acc_cnt[warp][q] += c;
        }
      }
      head += (skip + nw) / wpp;
      skip = (skip + nw) % wpp;
    }
    __syncthreads();

    for (int q = threadIdx.x; q < n; q += kThreads) {
      unsigned sum = 0u, cnt = 0u;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sum += acc_sum[w][q];
        cnt += acc_cnt[w][q];
      }
      if (cnt != 0u) {  // no match in this block adds nothing
        atomicAdd(out_sum + qc + q, sum);
        atomicAdd(out_cnt + qc + q, cnt);
      }
    }
    __syncthreads();  // the next chunk restages the shared arrays
  }
}

// Makes `device` current for the guard's lifetime (the caller's stream
// belongs to it) and puts the previous device back.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_;
};

// Blocks of `kernel` that fill the current device at `smem` bytes of
// dynamic shared memory: blocks per SM x SMs.  The answer is the same on
// every call, so each thread keeps the last few.
cudaError_t fill_blocks(const void* kernel, size_t smem, long long* blocks) {
  struct Entry {
    int device;
    const void* kernel;
    size_t smem;
    long long blocks;
  };
  thread_local Entry cache[8];
  thread_local int n_cached = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_cached && i < 8; ++i) {
    if (cache[i].device == dev && cache[i].kernel == kernel &&
        cache[i].smem == smem) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  *blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  cache[n_cached++ % 8] = Entry{dev, kernel, smem, *blocks};
  return cudaSuccess;
}

// K3's launch: one work item per coverage word of each shard, on a grid
// that fills the card (or one block per item when there are fewer).
cudaError_t masked_grid(int n_shards, int n_pages, long long* items,
                        long long* grid) {
  long long fill = 0;
  const cudaError_t err = fill_blocks(
      reinterpret_cast<const void*>(masked_filter_agg_kernel), 0, &fill);
  *items = (long long)n_shards * ((n_pages + 31) / 32);
  *grid = *items < fill ? *items : fill;
  return err;
}

// Zeroes the (2, nq) uint32 output (sums, then counts) on the stream.
cudaError_t zero_out(void* out, int nq, void* stream) {
  return cudaMemsetAsync(out, 0, sizeof(unsigned) * 2 * (size_t)nq,
                         static_cast<cudaStream_t>(stream));
}

// The stream path's view of five planes: 16-byte loads when every plane
// has the same address modulo 16 bytes, a multiple of 4 bytes.
Stream make_stream(const void* const* planes, int n_shards, int n_pages,
                   int page_size) {
  Stream p;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(planes[0]) % 16;
  p.vec = mis % 4 == 0;
  for (int i = 0; i < 5; ++i) {
    p.plane[i] = static_cast<const int32_t*>(planes[i]);
    p.vec = p.vec && reinterpret_cast<uintptr_t>(planes[i]) % 16 == mis;
  }
  p.off = p.vec ? (int)(mis / 4) : 0;
  p.shard_rows = (long long)n_pages * page_size;
  p.n_shards = n_shards;
  p.n_pages = n_pages;
  p.page_size = page_size;
  p.tile_rows = 0;
  return p;
}

int stream_launch(const void* const* planes, int n_shards, int n_pages,
                  int page_size, int tile_rows, const void* lo0,
                  const void* hi0, const void* lo1, const void* hi1,
                  const void* ts, const void* start_pages, int nq,
                  const void* local_pages, void* out, void* stream) {
  if (n_shards > kMaxShards || tile_rows <= 0 || tile_rows % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (nq <= 0) return 0;
  cudaError_t err = zero_out(out, nq, stream);
  if (err != cudaSuccess) return (int)err;
  if (n_shards <= 0 || n_pages <= 0 || page_size <= 0) return 0;
  Stream p = make_stream(planes, n_shards, n_pages, page_size);
  p.tile_rows = tile_rows;

  const size_t smem = sizeof(long long) * (3 * (size_t)n_shards + 1) +
                      sizeof(int) * (size_t)n_shards;
  long long fill = 0;
  err = fill_blocks(reinterpret_cast<const void*>(stream_filter_agg_kernel),
                    smem, &fill);
  if (err != cudaSuccess) return (int)err;
  const long long upper =
      (n_shards * p.shard_rows + p.off + tile_rows - 1) / tile_rows + n_shards;
  const unsigned grid = (unsigned)(upper < fill ? upper : fill);
  unsigned* sums = static_cast<unsigned*>(out);
  stream_filter_agg_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int32_t*>(lo0), static_cast<const int32_t*>(hi0),
      static_cast<const int32_t*>(lo1), static_cast<const int32_t*>(hi1),
      static_cast<const int32_t*>(ts),
      static_cast<const int32_t*>(start_pages), nq,
      static_cast<const int32_t*>(local_pages), sums, sums + nq);
  return (int)cudaGetLastError();
}

Planes make_planes(const void* pred0, const void* pred1, const void* agg,
                   const void* begin_ts, const void* end_ts, long long n_rows,
                   int page_size, int tile_rows) {
  Planes p;
  p.pred0 = static_cast<const int32_t*>(pred0);
  p.pred1 = static_cast<const int32_t*>(pred1);
  p.agg = static_cast<const int32_t*>(agg);
  p.begin_ts = static_cast<const int32_t*>(begin_ts);
  p.end_ts = static_cast<const int32_t*>(end_ts);
  p.n_rows = n_rows;
  p.page_size = page_size;
  p.tile_rows = tile_rows;
  return p;
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each makes `device`
// current, zeroes `out` -- (2, B) uint32: the B sums, then the B counts
// -- and launches on `stream`, a stream of that device; none
// synchronises.  Each returns the first CUDA error (0 on success).
// Planes are unit-stride: row r of a plane is plane[r].

extern "C" int filter_agg_launch(int device, const void* pred0,
                                 const void* pred1, const void* agg,
                                 const void* begin_ts, const void* end_ts,
                                 long long n_rows, int page_size,
                                 int tile_rows, int lo0, int hi0, int lo1,
                                 int hi1, int ts, int start_page, void* out,
                                 void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const cudaError_t err = zero_out(out, 1, stream);
  if (err != cudaSuccess) return (int)err;
  if (n_rows <= 0) return 0;
  const Planes p = make_planes(pred0, pred1, agg, begin_ts, end_ts, n_rows,
                               page_size, tile_rows);
  const long long n_tiles = (n_rows + tile_rows - 1) / tile_rows;
  const Bounds b{lo0, hi0, lo1, hi1, ts, start_page};
  unsigned* sums = static_cast<unsigned*>(out);
  filter_agg_kernel<<<(unsigned)n_tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p, b, sums,
                                                           sums + 1);
  return (int)cudaGetLastError();
}

// K3: the stream path over the open pages of S stacked shards of n_pages
// pages; words is (S, n_words) with n_words * 32 >= n_pages,
// local_pages (S,).
extern "C" int masked_filter_agg_launch(
    int device, const void* pred0, const void* pred1, const void* agg,
    const void* begin_ts, const void* end_ts, int n_shards, int n_pages,
    int page_size, const void* lo0, const void* hi0, const void* lo1,
    const void* hi1, const void* ts, int nq, const void* words, int n_words,
    const void* local_pages, void* out, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  // Stacked page ids (and one word's worth past them) are int32.
  if ((long long)n_words * 32 < n_pages ||
      (long long)n_shards * n_pages + 32 > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if (nq <= 0) return 0;
  cudaError_t err = zero_out(out, nq, stream);
  if (err != cudaSuccess) return (int)err;
  if (n_shards <= 0 || n_pages <= 0 || page_size <= 0) return 0;
  const void* planes[5] = {pred0, pred1, agg, begin_ts, end_ts};
  Masked m;
  m.p = make_stream(planes, n_shards, n_pages, page_size);
  m.words = static_cast<const uint32_t*>(words);
  m.local_pages = static_cast<const int32_t*>(local_pages);
  m.n_words = n_words;
  m.shard_words = (n_pages + 31) / 32;
  // Every page starts on the same 16-byte phase when page_size is a
  // multiple of 4; otherwise a page may start anywhere in a word.
  m.page_words = page_size % 4 == 0 ? page_size / 4 + (m.p.off != 0)
                                    : (page_size + 2) / 4 + 1;
  long long items = 0, grid = 0;
  err = masked_grid(n_shards, n_pages, &items, &grid);
  if (err != cudaSuccess) return (int)err;
  unsigned* sums = static_cast<unsigned*>(out);
  masked_filter_agg_kernel<<<(unsigned)grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<const int32_t*>(lo0), static_cast<const int32_t*>(hi0),
      static_cast<const int32_t*>(lo1), static_cast<const int32_t*>(hi1),
      static_cast<const int32_t*>(ts), nq, sums, sums + nq);
  return (int)cudaGetLastError();
}

// K3's work items and grid for S shards of n_pages pages, into
// shape[0] and shape[1] (reported by chip_smoke.py).
extern "C" int masked_filter_agg_shape(int device, int n_shards,
                                       int n_pages, long long* shape) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  return (int)masked_grid(n_shards, n_pages, shape, shape + 1);
}

// K1: the stream path on one shard whose pages are all real;
// start_pages is (B,), the (1, B) start table.
extern "C" int batched_filter_agg_launch(
    int device, const void* pred0, const void* pred1, const void* agg,
    const void* begin_ts, const void* end_ts, int n_pages, int page_size,
    int tile_rows, const void* lo0, const void* hi0, const void* lo1,
    const void* hi1, const void* ts, const void* start_pages, int nq,
    void* out, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const void* planes[5] = {pred0, pred1, agg, begin_ts, end_ts};
  return stream_launch(planes, 1, n_pages, page_size, tile_rows, lo0, hi0,
                       lo1, hi1, ts, start_pages, nq, nullptr, out, stream);
}

// K4: the stream path over S <= kMaxShards stacked shards of n_pages
// pages each; start_pages is (S, B), local_pages (S,).
extern "C" int sharded_filter_agg_launch(
    int device, const void* pred0, const void* pred1, const void* agg,
    const void* begin_ts, const void* end_ts, int n_shards, int n_pages,
    int page_size, int tile_rows, const void* lo0, const void* hi0,
    const void* lo1, const void* hi1, const void* ts,
    const void* start_pages, int nq, const void* local_pages, void* out,
    void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const void* planes[5] = {pred0, pred1, agg, begin_ts, end_ts};
  return stream_launch(planes, n_shards, n_pages, page_size, tile_rows, lo0,
                       hi0, lo1, hi1, ts, start_pages, nq, local_pages, out,
                       stream);
}
