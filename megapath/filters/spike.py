"""SPIKE coverage-anomaly filter.

Replaces the reference's bedtools bamtobed/genomecov + genomeCovFilter
+ bedtools annotate chain (runMegaPath.sh:211-221,
/root/reference/cc/genomeCovFilter.cpp): per reference sequence,
compute the depth profile from alignment intervals, flag regions whose
depth exceeds mean + k*stdev (streaming length-weighted moments in the
reference's exact update order), and drop reads whose alignment
overlaps flagged regions by >= overlap_frac of their span.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


@dataclass
class CoverageRuns:
    """bedtools genomecov -bga equivalent: per-seq depth runs."""

    seq: np.ndarray  # int32 [R]
    start: np.ndarray  # int64 [R]
    stop: np.ndarray  # int64 [R]
    depth: np.ndarray  # int64 [R]


def genome_coverage(
    seq_lens: Sequence[int],
    seq: np.ndarray,
    start: np.ndarray,
    stop: np.ndarray,
) -> CoverageRuns:
    """Depth runs (including zero-depth) from alignment intervals.

    Event-based: depth only changes at interval endpoints, so the runs
    come from one sort over ~2x the alignment count instead of a dense
    O(genome-length) diff/cumsum per sequence. Adjacent equal-depth
    runs are merged, making the output identical to the dense RLE
    (and thus the fold in spike_regions byte-identical)."""
    seq = np.asarray(seq, dtype=np.int64)
    slen_arr = np.asarray(seq_lens, dtype=np.int64)
    n_seqs = len(slen_arr)
    # rows with out-of-range seq ids (e.g. accessions absent from the
    # genome table) contribute no coverage — matching the reference's
    # per-sequence loop, which simply never visited them
    in_range = (seq >= 0) & (seq < n_seqs)
    if not in_range.all():
        seq = seq[in_range]
        start = np.asarray(start)[in_range]
        stop = np.asarray(stop)[in_range]
    live = slen_arr > 0
    # events: +1 at clipped starts, -1 at clipped stops, plus 0-delta
    # sentinels at 0 and slen for every non-empty sequence
    st = np.clip(start, 0, slen_arr[seq])
    en = np.clip(stop, 0, slen_arr[seq])
    sent_seq = np.flatnonzero(live).astype(np.int64)
    ev_seq = np.concatenate([seq, seq, sent_seq, sent_seq])
    ev_pos = np.concatenate(
        [st, en, np.zeros(len(sent_seq), np.int64), slen_arr[sent_seq]]
    )
    ev_delta = np.concatenate(
        [
            np.ones(len(seq), np.int64),
            -np.ones(len(seq), np.int64),
            np.zeros(2 * len(sent_seq), np.int64),
        ]
    )
    order = np.lexsort((ev_pos, ev_seq))
    ev_seq, ev_pos, ev_delta = ev_seq[order], ev_pos[order], ev_delta[order]
    cum = np.cumsum(ev_delta)  # per-seq deltas sum to 0 -> no reset needed
    n = len(ev_seq)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return CoverageRuns(z.astype(np.int32), z, z.copy(), z.copy())
    # depth after each distinct (seq, pos) breakpoint
    last = np.r_[
        (ev_seq[1:] != ev_seq[:-1]) | (ev_pos[1:] != ev_pos[:-1]), True
    ]
    b_seq = ev_seq[last]
    b_pos = ev_pos[last]
    b_depth = cum[last]
    # runs between consecutive breakpoints of the same seq
    has_next = np.r_[b_seq[1:] == b_seq[:-1], False]
    r_idx = np.flatnonzero(has_next)
    r_seq = b_seq[r_idx]
    r_start = b_pos[r_idx]
    r_stop = b_pos[r_idx + 1]
    r_depth = b_depth[r_idx]
    # merge adjacent equal-depth runs (zero-net-delta breakpoints)
    if len(r_idx):
        keep = np.r_[
            True,
            (r_seq[1:] != r_seq[:-1]) | (r_depth[1:] != r_depth[:-1]),
        ]
        grp_last = np.r_[keep[1:], True]
        r_seq = r_seq[keep]
        r_start = r_start[keep]
        r_stop = r_stop[grp_last]
        r_depth = r_depth[keep]
    return CoverageRuns(
        r_seq.astype(np.int32),
        r_start.astype(np.int64),
        r_stop.astype(np.int64),
        r_depth.astype(np.int64),
    )


def spike_regions(
    runs: CoverageRuns, n_seqs: int, max_depth_stdev: int = 60
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Regions with depth > mean + k*stdev per sequence.

    Byte-faithful to genomeCovFilter.cpp:61-93: the mean/variance use
    the streaming length-weighted update (population variance), and the
    comparison is strict (depth > threshold).
    """
    mean = np.zeros(n_seqs)
    diff_power = np.zeros(n_seqs)
    count = np.zeros(n_seqs)
    from megapath.native.build import load_spike_lib

    lib = load_spike_lib()
    if lib is not None and len(runs.seq):
        import ctypes

        seq_c = np.ascontiguousarray(runs.seq, dtype=np.int32)
        len_c = np.ascontiguousarray(runs.stop - runs.start, np.int64)
        dep_c = np.ascontiguousarray(runs.depth, dtype=np.int64)
        lib.spike_moments(
            seq_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dep_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            np.int64(len(seq_c)),
            mean.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            diff_power.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            count.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    else:
        for i in range(len(runs.seq)):
            s = runs.seq[i]
            ln = runs.stop[i] - runs.start[i]
            d = float(runs.depth[i])
            avg_diff = d - mean[s]
            new_mean = mean[s] + avg_diff * ln / (count[s] + ln)
            diff_power[s] += avg_diff**2 * ln * count[s] / (count[s] + ln)
            count[s] += ln
            mean[s] = new_mean
    variance = np.divide(diff_power, count, out=np.zeros_like(diff_power), where=count > 0)
    max_depth = mean + max_depth_stdev * np.sqrt(variance)

    flag = runs.depth > max_depth[runs.seq]
    return runs.seq[flag], runs.start[flag], runs.stop[flag]


def overlap_fraction(
    a_seq: np.ndarray,
    a_start: np.ndarray,
    a_stop: np.ndarray,
    r_seq: np.ndarray,
    r_start: np.ndarray,
    r_stop: np.ndarray,
) -> np.ndarray:
    """Fraction of each alignment interval covered by flagged regions
    (bedtools annotate equivalent)."""
    frac = np.zeros(len(a_seq))
    by_seq: Dict[int, List[int]] = {}
    for j in range(len(r_seq)):
        by_seq.setdefault(int(r_seq[j]), []).append(j)
    for s, idxs in by_seq.items():
        rs = r_start[idxs]
        re = r_stop[idxs]
        order = np.argsort(rs)
        rs, re = rs[order], re[order]
        am = np.flatnonzero(a_seq == s)
        for i in am:
            lo = np.searchsorted(re, a_start[i], "right")
            hi = np.searchsorted(rs, a_stop[i], "left")
            if hi <= lo:
                continue
            ov = np.minimum(re[lo:hi], a_stop[i]) - np.maximum(rs[lo:hi], a_start[i])
            span = a_stop[i] - a_start[i]
            if span > 0:
                frac[i] = ov[ov > 0].sum() / span
    return frac


def spike_read_filter(
    seq_lens: Sequence[int],
    aln_read: np.ndarray,  # read ids (any int key) per alignment
    aln_seq: np.ndarray,
    aln_start: np.ndarray,
    aln_stop: np.ndarray,
    max_depth_stdev: int = 60,
    overlap: float = 0.5,
) -> np.ndarray:
    """Read ids whose alignments overlap spike regions >= overlap.

    Mirrors runMegaPath.sh:215-221 (bamtobed -> genomecov -> filter ->
    annotate | awk $frac >= 0.5 -> read list).
    """
    runs = genome_coverage(seq_lens, aln_seq, aln_start, aln_stop)
    s_seq, s_start, s_stop = spike_regions(runs, len(seq_lens), max_depth_stdev)
    if len(s_seq) == 0:
        return np.zeros(0, dtype=aln_read.dtype)
    frac = overlap_fraction(aln_seq, aln_start, aln_stop, s_seq, s_start, s_stop)
    return np.unique(aln_read[frac >= overlap])
