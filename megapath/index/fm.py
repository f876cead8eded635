"""FM-index: BWT + occ checkpoints + sampled SA + k-mer lookup table.

Replacement for the reference's 2bwt index
(/root/reference/soap4/2bwt-lib/BWT.c, 2bwt-flex/LT.c): the occurrence
table is a flat checkpoint array every OCC_BLOCK bwt symbols plus the
2-bit packed BWT itself, so a rank query is one checkpoint gather + an
in-register popcount over at most OCC_BLOCK/16 uint32 words — a layout
chosen so thousands of backward-search walks batch into dense gathers
on device (vs the reference's per-thread pointer chasing).

Interval convention: half-open [lo, hi) over the n+1 rows of the full
BWT matrix (row 0 = sentinel suffix). ``count = hi - lo``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from megapath.index.suffix import suffix_array, bwt_from_sa

OCC_BLOCK = 128  # bwt symbols per occ checkpoint
WORD_CHARS = 16  # 2-bit chars per uint32 word
LOOKUP_K = 13  # reference LT k-mer size (2bwt-flex/LT.h:44-49)


def _pack_2bit(codes: np.ndarray, pad_to: Optional[int] = None) -> np.ndarray:
    """uint8 codes (0..3) -> uint32 words, 16 chars/word, LSB-first."""
    n = len(codes)
    total = pad_to if pad_to is not None else ((n + WORD_CHARS - 1) // WORD_CHARS) * WORD_CHARS
    buf = np.zeros(total, dtype=np.uint32)
    buf[:n] = codes
    buf = buf.reshape(-1, WORD_CHARS)
    shifts = (2 * np.arange(WORD_CHARS, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(buf << shifts, axis=1).astype(np.uint32)


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    shifts = (2 * np.arange(WORD_CHARS, dtype=np.uint32))[None, :]
    chars = ((words[:, None] >> shifts) & 3).astype(np.uint8)
    return chars.reshape(-1)[:n]


@dataclass
class FMIndex:
    """Arrays of one index shard. All device-transferable."""

    n: int  # text length (chars, no sentinel)
    primary: int  # full-BWT row holding the sentinel cell
    bwt_words: np.ndarray  # uint32 [ceil(n/16)] packed BWT (sentinel cell removed)
    occ: np.ndarray  # uint32 [n_blocks+1, 4] counts of c in bwt[:block*128]
    counts: np.ndarray  # int64 [5]: C[c] = first full-row of suffixes starting with c
    sa_sampled: np.ndarray  # int64/uint32 [n_marked] SA values at marked rows
    mark_rank: np.ndarray  # int32 [n+2] prefix count of marked rows <= r
    sa_interval: int  # text-position sampling stride (1 = full SA)
    lut_lo: Optional[np.ndarray] = None  # uint32 [4^k] full-row interval lo
    lut_hi: Optional[np.ndarray] = None
    lut_k: int = 0

    # ------------------------------------------------------------------
    # rank / backward search (numpy, batch-first: all args may be arrays)
    # ------------------------------------------------------------------
    def _occ_arr(self, idx: np.ndarray, c: np.ndarray) -> np.ndarray:
        """#occurrences of c in bwt[0:idx) (sentinel-free bwt coords)."""
        idx = np.asarray(idx, dtype=np.int64)
        c = np.asarray(c)
        block = idx // OCC_BLOCK
        base = self.occ[block, c].astype(np.int64)
        # in-block: count chars equal to c in bwt[block*128 : idx)
        rel = idx - block * OCC_BLOCK  # 0..127
        wpb = OCC_BLOCK // WORD_CHARS
        # clamp: when idx lands exactly on the final checkpoint, rel==0
        # masks out every gathered char, so any in-range words do
        word0 = np.minimum(block * wpb, max(0, len(self.bwt_words) - wpb))
        w = self.bwt_words[word0[..., None] + np.arange(wpb)]
        shifts = (2 * np.arange(WORD_CHARS, dtype=np.uint32))[None, :]
        chars = ((w[..., :, None] >> shifts) & 3).reshape(*idx.shape, OCC_BLOCK)
        pos = np.arange(OCC_BLOCK)
        inblk = ((chars == c[..., None]) & (pos < rel[..., None])).sum(axis=-1)
        return base + inblk

    def occ_full(self, row: np.ndarray, c: np.ndarray) -> np.ndarray:
        """#occurrences of c among full-BWT rows [0, row)."""
        row = np.asarray(row, dtype=np.int64)
        adj = row - (row > self.primary)
        return self._occ_arr(adj, c)

    def extend_backward(
        self, lo: np.ndarray, hi: np.ndarray, c: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Prepend char c to the pattern: [lo,hi) -> new interval."""
        C = self.counts[np.asarray(c)]
        return C + self.occ_full(lo, c), C + self.occ_full(hi, c)

    def bwt_char_full(self, row: np.ndarray) -> np.ndarray:
        """BWT char of full rows (undefined at row==primary)."""
        row = np.asarray(row, dtype=np.int64)
        adj = row - (row > self.primary)
        w = self.bwt_words[adj // WORD_CHARS]
        return ((w >> (2 * (adj % WORD_CHARS).astype(np.uint32))) & 3).astype(np.uint8)

    def lf(self, row: np.ndarray) -> np.ndarray:
        """LF-mapping of full rows; primary row maps to 0."""
        row = np.asarray(row, dtype=np.int64)
        c = self.bwt_char_full(np.where(row == self.primary, 0, row))
        out = self.counts[c] + self.occ_full(row, c)
        return np.where(row == self.primary, 0, out)

    def locate(self, rows: np.ndarray) -> np.ndarray:
        """Text positions of full rows (vectorized LF walk to samples)."""
        rows = np.asarray(rows, dtype=np.int64)
        pos = np.full(rows.shape, -1, dtype=np.int64)
        steps = np.zeros(rows.shape, dtype=np.int64)
        cur = rows.copy()
        for _ in range(self.sa_interval + 1):
            at_sent = cur == 0
            marked = self._is_marked(cur) & ~at_sent
            hit = (pos < 0) & marked
            if hit.any():
                pos[hit] = self._sample_value(cur[hit]) + steps[hit]
            hit0 = (pos < 0) & at_sent
            pos[hit0] = self.n + steps[hit0]  # sentinel row = position n
            todo = pos < 0
            if not todo.any():
                break
            cur = np.where(todo, self.lf(cur), cur)
            steps = steps + todo
        return pos

    def _is_marked(self, row: np.ndarray) -> np.ndarray:
        return (self.mark_rank[row + 1] - self.mark_rank[row]) > 0

    def _sample_value(self, row: np.ndarray) -> np.ndarray:
        return self.sa_sampled[self.mark_rank[row]].astype(np.int64)

    # ------------------------------------------------------------------
    def lut_interval(self, kmer: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Packed k-mer codes (base-4, first char most significant) ->
        full-row interval [lo, hi)."""
        return self.lut_lo[kmer].astype(np.int64), self.lut_hi[kmer].astype(np.int64)

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            n=self.n,
            primary=self.primary,
            bwt_words=self.bwt_words,
            occ=self.occ,
            counts=self.counts,
            sa_sampled=self.sa_sampled,
            mark_rank=self.mark_rank,
            sa_interval=self.sa_interval,
            lut_lo=self.lut_lo if self.lut_lo is not None else np.zeros(0, np.uint32),
            lut_hi=self.lut_hi if self.lut_hi is not None else np.zeros(0, np.uint32),
            lut_k=self.lut_k,
        )

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        z = np.load(path)
        lut_k = int(z["lut_k"])
        return cls(
            n=int(z["n"]),
            primary=int(z["primary"]),
            bwt_words=z["bwt_words"],
            occ=z["occ"],
            counts=z["counts"],
            sa_sampled=z["sa_sampled"],
            mark_rank=z["mark_rank"],
            sa_interval=int(z["sa_interval"]),
            lut_lo=z["lut_lo"] if lut_k else None,
            lut_hi=z["lut_hi"] if lut_k else None,
            lut_k=lut_k,
        )


def build_fm_index(
    codes: np.ndarray,
    sa_interval: int = 8,
    lut_k: int = LOOKUP_K,
    sa: Optional[np.ndarray] = None,
) -> FMIndex:
    """Build the FM-index of a packed reference text."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    if sa is None:
        sa = suffix_array(codes)
    bwt, primary = bwt_from_sa(codes, sa)

    # counts: C[c] = 1 + #chars < c (sentinel occupies row 0)
    hist = np.bincount(codes, minlength=4).astype(np.int64)
    counts = np.zeros(5, dtype=np.int64)
    counts[1:] = np.cumsum(hist)
    counts += 1  # rows shift by the sentinel row
    counts[0] = 1

    # occ checkpoints over the sentinel-free bwt
    n_blocks = (n + OCC_BLOCK - 1) // OCC_BLOCK
    pad = n_blocks * OCC_BLOCK
    onehot = np.zeros((pad, 4), dtype=np.uint32)
    onehot[np.arange(n), bwt] = 1
    per_block = onehot.reshape(n_blocks, OCC_BLOCK, 4).sum(axis=1, dtype=np.uint64)
    occ = np.zeros((n_blocks + 1, 4), dtype=np.uint32)
    occ[1:] = np.cumsum(per_block, axis=0).astype(np.uint32)

    bwt_words = _pack_2bit(bwt, pad_to=pad)

    # sampled SA: mark full rows whose text position % sa_interval == 0
    # full row r>0 -> position sa[r-1]; row 0 (sentinel) handled specially
    full_pos = np.empty(n + 1, dtype=np.int64)
    full_pos[0] = n
    full_pos[1:] = sa
    marked = (full_pos % sa_interval) == 0
    marked[0] = False
    mark_rank = np.zeros(n + 2, dtype=np.int64)
    mark_rank[1:] = np.cumsum(marked)
    sa_sampled = full_pos[marked]

    fm = FMIndex(
        n=n,
        primary=primary,
        bwt_words=bwt_words,
        occ=occ,
        counts=counts,
        sa_sampled=sa_sampled,
        mark_rank=mark_rank.astype(np.int64),
        sa_interval=sa_interval,
    )

    if lut_k:
        fm.lut_lo, fm.lut_hi = _build_lut(codes, sa, lut_k)
        fm.lut_k = lut_k
    return fm


def _build_lut(codes: np.ndarray, sa: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """k-mer -> full-row interval [lo, hi), replacing 2bwt-flex LT.

    Keys are computed per suffix from its first k chars (A-padded);
    suffixes shorter than k (at most k-1 of them) are then excised from
    their padded bucket since they cannot contain a full k-mer.
    """
    n = len(codes)
    # key[r] for suffix sa[r]: base-4 big-endian of codes[sa[r] : sa[r]+k]
    key = np.zeros(n, dtype=np.int64)
    for j in range(k):
        idx = sa + j
        ch = np.where(idx < n, codes[np.minimum(idx, n - 1)], 0)
        key = key * 4 + ch
    # bucket boundaries among the n suffix rows (full rows 1..n)
    size = 4**k
    uniq, cnt = np.unique(key, return_counts=True)
    starts = np.zeros(size + 1, dtype=np.int64)
    np.add.at(starts, uniq + 1, cnt)
    starts = np.cumsum(starts)
    lo = starts[:-1] + 1  # +1: full rows are suffix rows shifted by sentinel
    hi = starts[1:] + 1
    # excise short suffixes (positions n-1 .. n-k+1) from their buckets
    short_positions = np.arange(max(0, n - k + 1), n)
    if len(short_positions):
        row_of = np.empty(n, dtype=np.int64)
        row_of[sa] = np.arange(n)
        for p in short_positions:
            r = row_of[p]  # suffix row; full row = r+1
            b = key[r]
            # short suffixes sort before all full-length members (A-pad
            # ties break by the implicit sentinel); bump lo past them
            if lo[b] <= r + 1 < hi[b]:
                lo[b] = r + 2
    return lo.astype(np.uint32), hi.astype(np.uint32)
