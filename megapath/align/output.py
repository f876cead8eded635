"""Hit aggregation and cfq/LSAM output.

Equivalent of soap4's megapath output sinks (BGS-IO.cpp
pairDeepDPOutputFastqAPI :1966-2093 and unproperlypairDPOutputFastqAPI
:1384-1446): per read end, keep the best score per reference sequence,
retain hits >= top_percentage * best, merge hits carried from previous
shards, and emit ``SCORE:`` comments. megapath_mode==2 drops unpaired
ends entirely.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from megapath.align.engine import BatchHits
from megapath.align.params import AlignParams
from megapath.index.pack import PackedReference
from megapath.io.fastq import FastqRecord


def best_per_seq(
    hits: BatchHits, n_pairs: int, megapath_mode: int = 1
) -> List[List[Dict[int, int]]]:
    """[end][pair] -> {seq: best normalized score}.

    megapath_mode==2 (pair-required): unpaired hits are discarded
    (BGS-IO.cpp:2001-2010).
    """
    table: List[List[Dict[int, int]]] = [
        [dict() for _ in range(n_pairs)] for _ in range(2)
    ]
    for i in range(len(hits)):
        if megapath_mode == 2 and not hits.paired[i]:
            continue
        d = table[int(hits.end[i])][int(hits.read[i])]
        s = int(hits.score[i])
        q = int(hits.seq[i])
        if s > d.get(q, 0):
            d[q] = s
    return table


def best_per_seq_arrays(
    hits: BatchHits, megapath_mode: int = 1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized group-best: returns (read, end, seq, best_score)
    arrays with one row per (read, end, seq) group."""
    if len(hits) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.int32), z.astype(np.int8), z.astype(np.int32), z.astype(np.int32)
    m = np.ones(len(hits), dtype=bool)
    if megapath_mode == 2:
        m = hits.paired
    read, end, seq, score = hits.read[m], hits.end[m], hits.seq[m], hits.score[m]
    order = np.lexsort((-score, seq, read, end))
    read, end, seq, score = read[order], end[order], seq[order], score[order]
    first = np.r_[
        True,
        (read[1:] != read[:-1]) | (end[1:] != end[:-1]) | (seq[1:] != seq[:-1]),
    ]
    return read[first], end[first], seq[first], score[first]


def format_comment(
    seq_scores: Dict[int, int],
    ref: PackedReference,
    params: AlignParams,
    prev_comment: str = "",
) -> str:
    """One read end's ``SCORE:`` comment, merging prior-shard hits.

    Follows getMappingFromHeader + the output loops
    (BGS-IO.cpp:1348-1371, 2040-2061): new hits sorted by sequence
    index (best per seq), then prior hits appended in their original
    order; everything filtered at best * top_percentage.
    """
    if prev_comment == "IGNORE":
        return "IGNORE"

    best = max(seq_scores.values(), default=0)

    prev_hits: List[str] = []
    prev_best = 0
    if prev_comment.startswith("SCORE:"):
        head = prev_comment[6:]
        segs = head.split(";")
        try:
            prev_best = int(segs[0])
        except ValueError:
            prev_best = 0
        prev_hits = [s for s in segs[1:] if s]
    if prev_best > best:
        best = prev_best

    parts: List[str] = []
    if best > 0:
        thr = best * params.top_percentage
        for seq_idx in sorted(seq_scores):
            s = seq_scores[seq_idx]
            if s > 0 and s >= thr:
                parts.append(f"{s},{ref.names[seq_idx]}")
        for seg in prev_hits:
            try:
                ps = int(seg.split(",", 1)[0])
            except ValueError:
                continue
            if ps >= thr:
                parts.append(seg)
    return f"SCORE:{best};" + "".join(p + ";" for p in parts)


def emit_cfq(
    hits: BatchHits,
    n_pairs: int,
    names: Sequence[str],
    seqs1: Sequence[str],
    quals1: Sequence[str],
    seqs2: Sequence[str],
    quals2: Sequence[str],
    ref: PackedReference,
    params: AlignParams,
    prev_comments1: Optional[Sequence[str]] = None,
    prev_comments2: Optional[Sequence[str]] = None,
) -> Iterable[FastqRecord]:
    """Interleaved cfq records for a pair batch (soap4 stdout shape)."""
    table = best_per_seq(hits, n_pairs, params.megapath_mode)
    for r in range(n_pairs):
        for end, (seqs, quals, prev) in enumerate(
            (
                (seqs1, quals1, prev_comments1),
                (seqs2, quals2, prev_comments2),
            )
        ):
            pc = prev[r] if prev is not None else ""
            comment = format_comment(table[end][r], ref, params, pc)
            yield FastqRecord(
                name=names[r], seq=seqs[r], qual=quals[r], comment=comment
            )


def coverage_intervals(
    hits: BatchHits, ref: PackedReference, params: AlignParams
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(seq, local_start, local_stop) arrays of kept alignments for the
    SPIKE coverage filter (bedtools bamtobed/genomecov replacement)."""
    if len(hits) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.int32), z, z.copy()
    seq = hits.seq.astype(np.int64)
    off = ref.offsets[seq]
    return hits.seq, hits.start - off, hits.stop - off
