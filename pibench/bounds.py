"""Peaks of the card and the least time a scan kernel's launch needs.

Peaks: NVIDIA H100 SXM data sheet (dense, 700 W): 3.35 TB/s of HBM3;
int32 issue rate 132 SMs x 64 INT32 lanes x 1.98 GHz (Hopper white
paper).  A roofline share is stated against these, with the card's
power limit beside it.

The counts are of the work a launch's inputs need, whatever kernel
serves it: each distinct input plane read once over the rows the
launch must cover, each per-query operand read once, each output
written once; the compares and adds are counted per row each query
covers.  Copied from the repository's chip smoke test
(``scan_bound``, ``masked_bound``), with the planes counted as the
launch passes them (a single-attribute query passes its predicate
plane twice, and a predicate may be the aggregated attribute).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_ROW_QUERY = 9  # 4 range + 2 visibility + 1 page compares, 2 adds


def _bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def k1_bound_s(n_pages: int, page_size: int, n_planes: int,
               start_pages) -> float:
    """Least seconds of one K1 launch: queries starting at
    ``start_pages`` (their stitch points) over ``n_pages`` pages of
    ``n_planes`` distinct planes."""
    def rows_from(p):
        return max(n_pages - max(int(p), 0), 0) * page_size

    b = len(start_pages)
    rows = rows_from(min(start_pages)) if b else 0
    nbytes = rows * 4 * n_planes + b * 6 * 4 + b * 2 * 4
    ops = sum(rows_from(p) for p in start_pages) * OPS_PER_ROW_QUERY
    return _bound_s(nbytes, ops)


def k3_bound_s(n_uncovered: int, page_size: int, n_planes: int,
               n_queries: int, n_words: int) -> float:
    """Least seconds of one K3 launch: the uncovered real pages of
    ``n_planes`` distinct planes, the coverage words and per-query
    operands read once, outputs written once; every query covers every
    uncovered row."""
    rows = n_uncovered * page_size
    nbytes = (rows * 4 * n_planes + n_words * 4 + n_queries * 5 * 4
              + n_queries * 2 * 4)
    ops = rows * n_queries * OPS_PER_ROW_QUERY
    return _bound_s(nbytes, ops)


def uncovered_pages(words, local_pages) -> int:
    """Real pages (local page < ``local_pages[s]``) whose coverage bit
    is clear, over (S, W) int32 packed words (bit p & 31 of word p >> 5
    is page p)."""
    total = 0
    for s, row in enumerate(words):
        n = int(local_pages[s])
        covered = 0
        for w, word in enumerate(row):
            bits = int(word) & 0xFFFFFFFF
            if not bits:
                continue
            lo = w * 32
            if lo + 32 > n:  # the last word: only real pages count
                bits &= (1 << max(n - lo, 0)) - 1
            covered += bin(bits).count("1")
        total += n - covered
    return total
