// Fused predicate-filter + aggregate table scans for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels on the read path:
//   K1  src/repro/kernels/batched_filter_agg.py:163  batched_filter_agg
//       (kernel body _batched_kernel)   -> batched_filter_agg_launch
//   K2  src/repro/kernels/filter_agg.py:103          filter_agg
//       (kernel body _filter_agg_kernel) -> filter_agg_launch
//   K3  src/repro/kernels/batched_filter_agg.py:483
//       sharded_batched_filter_agg_masked
//       (kernel body _masked_sharded_kernel) -> masked_filter_agg_launch
//   K4  src/repro/kernels/batched_filter_agg.py:308
//       sharded_batched_filter_agg
//       (kernel body _sharded_kernel)   -> sharded_filter_agg_launch
// K2 is the B = 1 instance of K1: both entry points run the same tile
// body, so a one-query batch is bit-identical to the single-query scan.
// K3 runs the same tile body over the UNCOVERED pages of a coverage
// bitmap (notes at masked_filter_agg_kernel below), K4 over S stacked
// shards with per-(shard, query) local start pages (notes at
// sharded_filter_agg_kernel).
//
// Semantics (src/repro/kernels/ref.py): for each query q, SUM(agg) and
// COUNT(*) over the rows with
//   lo0[q] <= pred0 <= hi0[q]  and  lo1[q] <= pred1 <= hi1[q]
//   and begin_ts <= ts[q] < end_ts  and  page >= start_page[q],
// both wrapping like int32.
//
// What bounds it on the H100: bytes.  Per row it reads five int32 values
// and does about ten integer operations per query, far below the card's
// integer rate, so the floor is the HBM stream (3.35 TB/s).  The design
// answers that three ways:
//   * Every row is loaded once per launch, whatever the batch size: a
//     thread keeps its rows' five values in registers and loops over the
//     queries, whose bounds sit in shared memory (the TPU kernel's "one
//     stream of the tile per batch").
//   * The predicate and aggregate columns are read in place out of the
//     table's (n_pages, page_size, n_attrs) array with element stride
//     n_attrs, so no column is copied per dispatch.  The price is that a
//     column read pulls whole 32-byte sectors of the row-major table.
//   * A tile that lies wholly below every query's start_page returns
//     before it loads anything (the TPU kernel's pre-DMA skip); inside a
//     tile, rows below a query's start_page are masked per query, and a
//     query whose start_page lies past the tile skips it.
// The TPU grid ran in order on one core; here tiles are independent
// blocks.  Partial sums are accumulated in uint32 (signed overflow is
// undefined in C++; unsigned addition wraps and commutes), reduced per
// warp with shuffles and per block in shared memory, then added to the
// (B,) output with atomicAdd, so the result does not depend on the order
// in which blocks finish.

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
  long long stride0;  // element stride between consecutive rows
  long long stride1;
  long long stride_agg;
  long long stride_begin;
  long long stride_end;
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

// K3's page filter: a row takes part only if its page's coverage bit
// is 0.  `words` is the shard's row of packed little-endian words
// (bit p & 31 of word p >> 5 is local page p), `page_base` the global
// page id of the shard's local page 0.
struct Coverage {
  const uint32_t* words;
  long long page_base;
};

// Scan rows [row0, row_end) for the nq <= kQueryChunk queries whose
// bounds are staged in shared memory, and add the block's partial sums
// into out_sum[0:nq] / out_cnt[0:nq].  With kMasked, rows of covered
// pages are dropped (the caller keeps row_end inside the pages that
// have a word).  Every thread of the block must call it: the loops
// below are uniform across the block, so the warp shuffles always see
// full warps.
template <bool kMasked>
__device__ void scan_tile(const Planes& p, const Bounds* qs, int nq,
                          long long row0, long long row_end,
                          const Coverage& cov, unsigned* out_sum,
                          unsigned* out_cnt) {
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
      if (kMasked && live[k]) {  // a covered page's rows load nothing
        const int lp = (int)(r / p.page_size - cov.page_base);
        live[k] = ((cov.words[lp >> 5] >> (lp & 31)) & 1u) == 0u;
      }
      if (live[k]) {
        v0[k] = p.pred0[r * p.stride0];
        v1[k] = p.pred1[r * p.stride1];
        va[k] = p.agg[r * p.stride_agg];
        bt[k] = p.begin_ts[r * p.stride_begin];
        et[k] = p.end_ts[r * p.stride_end];
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

// K1: one block per tile of pages, every query of the batch.
__global__ void __launch_bounds__(kThreads)
batched_filter_agg_kernel(Planes p, const int32_t* __restrict__ lo0,
                          const int32_t* __restrict__ hi0,
                          const int32_t* __restrict__ lo1,
                          const int32_t* __restrict__ hi1,
                          const int32_t* __restrict__ ts,
                          const int32_t* __restrict__ start_pages, int nq,
                          unsigned* out_sum, unsigned* out_cnt) {
  __shared__ Bounds qs[kQueryChunk];
  __shared__ int min_start;
  const long long row0 = (long long)blockIdx.x * p.tile_rows;
  const long long row_end =
      row0 + p.tile_rows < p.n_rows ? row0 + p.tile_rows : p.n_rows;
  const int last_page = (int)((row_end - 1) / p.page_size);

  if (threadIdx.x == 0) min_start = INT32_MAX;
  __syncthreads();
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    atomicMin(&min_start, start_pages[q]);
  }
  __syncthreads();
  if (last_page < min_start) return;  // inside every query's prefix

  for (int qc = 0; qc < nq; qc += kQueryChunk) {
    const int n = nq - qc < kQueryChunk ? nq - qc : kQueryChunk;
    for (int q = threadIdx.x; q < n; q += kThreads) {
      qs[q] = Bounds{lo0[qc + q], hi0[qc + q], lo1[qc + q],
                     hi1[qc + q], ts[qc + q], start_pages[qc + q]};
    }
    __syncthreads();
    scan_tile<false>(p, qs, n, row0, row_end, Coverage{}, out_sum + qc,
                     out_cnt + qc);
  }
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
  scan_tile<false>(p, qs, 1, row0, row_end, Coverage{}, out_sum, out_cnt);
}

// K3: the scan over the pages a coverage bitmap leaves uncovered, over
// S stacked shards of n_pages pages each (a plain table is S = 1).
// Grid (tiles of one shard, shard).  What bounds it is the same as K1
// (bytes, of the uncovered pages only); the TPU kernel's live-block
// window and pre-DMA skip become an early return: a block first reads
// its tile's coverage words (at most ceil(tile_pages / 32) + 1) and
// returns before it loads any row when every page of its tile is
// covered or lies at or past the shard's local_pages.  Inside a live
// tile each row tests its page's bit.
//
// Unlike the TPU kernel, which reads words[s, p / 32] for padding
// pages past W * 32, no word at or past W is ever read: the wrapper
// requires W * 32 >= n_pages, and pages at or past local_pages[s]
// contribute nothing.  Where the reference's contract holds (padding
// pages carry begin_ts = INT32_MAX and so are invisible) the results
// are the same.
__global__ void __launch_bounds__(kThreads)
masked_filter_agg_kernel(Planes p, int n_pages, int tile_pages,
                         const int32_t* __restrict__ lo0,
                         const int32_t* __restrict__ hi0,
                         const int32_t* __restrict__ lo1,
                         const int32_t* __restrict__ hi1,
                         const int32_t* __restrict__ ts, int nq,
                         const uint32_t* __restrict__ words, int n_words,
                         const int32_t* __restrict__ local_pages,
                         unsigned* out_sum, unsigned* out_cnt) {
  __shared__ Bounds qs[kQueryChunk];
  const int s = blockIdx.y;
  const long long first = (long long)blockIdx.x * tile_pages;
  long long last = first + tile_pages;  // exclusive
  if (last > n_pages) last = n_pages;
  if (last > local_pages[s]) last = local_pages[s];
  if (first >= last) return;  // padding past the shard's real pages

  const Coverage cov{words + (long long)s * n_words, (long long)s * n_pages};
  int open = 0;
  for (long long pg = first + threadIdx.x; pg < last; pg += kThreads) {
    open |= ((cov.words[pg >> 5] >> (pg & 31)) & 1u) == 0u;
  }
  if (!__syncthreads_or(open)) return;  // every page covered: load nothing

  const long long row0 = (cov.page_base + first) * p.page_size;
  const long long row_end = (cov.page_base + last) * p.page_size;
  for (int qc = 0; qc < nq; qc += kQueryChunk) {
    const int n = nq - qc < kQueryChunk ? nq - qc : kQueryChunk;
    for (int q = threadIdx.x; q < n; q += kThreads) {
      qs[q] = Bounds{lo0[qc + q], hi0[qc + q], lo1[qc + q],
                     hi1[qc + q], ts[qc + q], 0};
    }
    __syncthreads();
    scan_tile<true>(p, qs, n, row0, row_end, cov, out_sum + qc,
                    out_cnt + qc);
  }
}

// K4: K1 over S stacked shards of n_pages pages each.  Grid (tiles of
// one shard, shard), as K3's.  What bounds it is K1's: bytes, five
// int32 reads per row of the pages at or past each shard's smallest
// local start.  start_pages is (S, nq), the LOCAL stitch point of each
// (shard, query) pair; a row of shard s, local page p counts for query
// q iff start_pages[s, q] <= p < local_pages[s].
//
// The TPU kernel clamps each shard's block coordinate into the window
// [first block any query needs, last block holding real pages], so
// prefix blocks and trailing padding blocks revisit a resident block
// and skip their DMA.  Here a block returns before it loads a row in
// the same two cases: its tile lies at or past local_pages[s] (K3's
// clamp; padding rows are never read), or it lies wholly below every
// query's local start (K1's min_start exit, per shard).  Inside a live
// tile scan_tile's page test runs on stacked page ids, so the block
// stages each query's start as s * n_pages + start_pages[s, q], the
// local start clamped into [0, n_pages] first so the sum cannot
// overflow.
__global__ void __launch_bounds__(kThreads)
sharded_filter_agg_kernel(Planes p, int n_pages, int tile_pages,
                          const int32_t* __restrict__ lo0,
                          const int32_t* __restrict__ hi0,
                          const int32_t* __restrict__ lo1,
                          const int32_t* __restrict__ hi1,
                          const int32_t* __restrict__ ts,
                          const int32_t* __restrict__ start_pages, int nq,
                          const int32_t* __restrict__ local_pages,
                          unsigned* out_sum, unsigned* out_cnt) {
  __shared__ Bounds qs[kQueryChunk];
  __shared__ int min_start;
  const int s = blockIdx.y;
  const long long first = (long long)blockIdx.x * tile_pages;
  long long last = first + tile_pages;  // exclusive
  if (last > n_pages) last = n_pages;
  if (last > local_pages[s]) last = local_pages[s];
  if (first >= last) return;  // padding past the shard's real pages

  const int32_t* starts = start_pages + (long long)s * nq;
  if (threadIdx.x == 0) min_start = INT32_MAX;
  __syncthreads();
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    atomicMin(&min_start, starts[q]);
  }
  __syncthreads();
  if (last - 1 < min_start) return;  // inside every query's prefix

  const long long base = (long long)s * n_pages;
  const long long row0 = (base + first) * p.page_size;
  const long long row_end = (base + last) * p.page_size;
  for (int qc = 0; qc < nq; qc += kQueryChunk) {
    const int n = nq - qc < kQueryChunk ? nq - qc : kQueryChunk;
    for (int q = threadIdx.x; q < n; q += kThreads) {
      int st = starts[qc + q];
      st = st < 0 ? 0 : (st > n_pages ? n_pages : st);
      qs[q] = Bounds{lo0[qc + q], hi0[qc + q], lo1[qc + q],
                     hi1[qc + q], ts[qc + q], (int)(base + st)};
    }
    __syncthreads();
    scan_tile<false>(p, qs, n, row0, row_end, Coverage{}, out_sum + qc,
                     out_cnt + qc);
  }
}

Planes make_planes(const void* pred0, long long stride0, const void* pred1,
                   long long stride1, const void* agg, long long stride_agg,
                   const void* begin_ts, long long stride_begin,
                   const void* end_ts, long long stride_end, long long n_rows,
                   int page_size, int tile_rows) {
  Planes p;
  p.pred0 = static_cast<const int32_t*>(pred0);
  p.pred1 = static_cast<const int32_t*>(pred1);
  p.agg = static_cast<const int32_t*>(agg);
  p.begin_ts = static_cast<const int32_t*>(begin_ts);
  p.end_ts = static_cast<const int32_t*>(end_ts);
  p.stride0 = stride0;
  p.stride1 = stride1;
  p.stride_agg = stride_agg;
  p.stride_begin = stride_begin;
  p.stride_end = stride_end;
  p.n_rows = n_rows;
  p.page_size = page_size;
  p.tile_rows = tile_rows;
  return p;
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 on success).
// The caller zeroes out_sum / out_cnt, (B,) uint32 each.

extern "C" int batched_filter_agg_launch(
    const void* pred0, long long stride0, const void* pred1,
    long long stride1, const void* agg, long long stride_agg,
    const void* begin_ts, long long stride_begin, const void* end_ts,
    long long stride_end, long long n_rows, int page_size, int tile_rows,
    const void* lo0, const void* hi0, const void* lo1, const void* hi1,
    const void* ts, const void* start_pages, int nq, void* out_sum,
    void* out_cnt, void* stream) {
  if (n_rows <= 0 || nq <= 0) return 0;
  const Planes p = make_planes(pred0, stride0, pred1, stride1, agg,
                               stride_agg, begin_ts, stride_begin, end_ts,
                               stride_end, n_rows, page_size, tile_rows);
  const long long n_tiles = (n_rows + tile_rows - 1) / tile_rows;
  batched_filter_agg_kernel<<<(unsigned)n_tiles, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int32_t*>(lo0), static_cast<const int32_t*>(hi0),
      static_cast<const int32_t*>(lo1), static_cast<const int32_t*>(hi1),
      static_cast<const int32_t*>(ts),
      static_cast<const int32_t*>(start_pages), nq,
      static_cast<unsigned*>(out_sum), static_cast<unsigned*>(out_cnt));
  return (int)cudaGetLastError();
}

extern "C" int filter_agg_launch(
    const void* pred0, long long stride0, const void* pred1,
    long long stride1, const void* agg, long long stride_agg,
    const void* begin_ts, long long stride_begin, const void* end_ts,
    long long stride_end, long long n_rows, int page_size, int tile_rows,
    int lo0, int hi0, int lo1, int hi1, int ts, int start_page,
    void* out_sum, void* out_cnt, void* stream) {
  if (n_rows <= 0) return 0;
  const Planes p = make_planes(pred0, stride0, pred1, stride1, agg,
                               stride_agg, begin_ts, stride_begin, end_ts,
                               stride_end, n_rows, page_size, tile_rows);
  const long long n_tiles = (n_rows + tile_rows - 1) / tile_rows;
  const Bounds b{lo0, hi0, lo1, hi1, ts, start_page};
  filter_agg_kernel<<<(unsigned)n_tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      p, b, static_cast<unsigned*>(out_sum), static_cast<unsigned*>(out_cnt));
  return (int)cudaGetLastError();
}

extern "C" int masked_filter_agg_launch(
    const void* pred0, long long stride0, const void* pred1,
    long long stride1, const void* agg, long long stride_agg,
    const void* begin_ts, long long stride_begin, const void* end_ts,
    long long stride_end, long long n_rows, int page_size, int tile_rows,
    const void* lo0, const void* hi0, const void* lo1, const void* hi1,
    const void* ts, int nq, const void* words, int n_words,
    const void* local_pages, int n_shards, int n_pages, void* out_sum,
    void* out_cnt, void* stream) {
  if (n_rows <= 0 || nq <= 0 || n_shards <= 0) return 0;
  const Planes p = make_planes(pred0, stride0, pred1, stride1, agg,
                               stride_agg, begin_ts, stride_begin, end_ts,
                               stride_end, n_rows, page_size, tile_rows);
  const int tile_pages = tile_rows / page_size;
  const long long n_tiles = ((long long)n_pages + tile_pages - 1) / tile_pages;
  const dim3 grid((unsigned)n_tiles, (unsigned)n_shards);
  masked_filter_agg_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      p, n_pages, tile_pages, static_cast<const int32_t*>(lo0),
      static_cast<const int32_t*>(hi0), static_cast<const int32_t*>(lo1),
      static_cast<const int32_t*>(hi1), static_cast<const int32_t*>(ts), nq,
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const int32_t*>(local_pages),
      static_cast<unsigned*>(out_sum), static_cast<unsigned*>(out_cnt));
  return (int)cudaGetLastError();
}

extern "C" int sharded_filter_agg_launch(
    const void* pred0, long long stride0, const void* pred1,
    long long stride1, const void* agg, long long stride_agg,
    const void* begin_ts, long long stride_begin, const void* end_ts,
    long long stride_end, long long n_rows, int page_size, int tile_rows,
    const void* lo0, const void* hi0, const void* lo1, const void* hi1,
    const void* ts, const void* start_pages, int nq,
    const void* local_pages, int n_shards, int n_pages, void* out_sum,
    void* out_cnt, void* stream) {
  if (n_rows <= 0 || nq <= 0 || n_shards <= 0) return 0;
  const Planes p = make_planes(pred0, stride0, pred1, stride1, agg,
                               stride_agg, begin_ts, stride_begin, end_ts,
                               stride_end, n_rows, page_size, tile_rows);
  const int tile_pages = tile_rows / page_size;
  const long long n_tiles = ((long long)n_pages + tile_pages - 1) / tile_pages;
  const dim3 grid((unsigned)n_tiles, (unsigned)n_shards);
  sharded_filter_agg_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      p, n_pages, tile_pages, static_cast<const int32_t*>(lo0),
      static_cast<const int32_t*>(hi0), static_cast<const int32_t*>(lo1),
      static_cast<const int32_t*>(hi1), static_cast<const int32_t*>(ts),
      static_cast<const int32_t*>(start_pages), nq,
      static_cast<const int32_t*>(local_pages),
      static_cast<unsigned*>(out_sum), static_cast<unsigned*>(out_cnt));
  return (int)cudaGetLastError();
}
