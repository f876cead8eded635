"""SAM output for alignment hits.

Replaces the reference's vendored samtools BAM sink (soap4 -b,
/root/reference/soap4/SOAP4.cpp:346-354, BGS-IO.cpp SAM APIs) with a
plain SAM text writer driven by BatchHits + host tracebacks. BAM (BGZF)
encoding can be layered on, but every downstream consumer in the
pipeline (bamtobed/genomecov equivalents) is already in-process, so
SAM text is an interchange convenience.

MAPQ follows the reference's BWA-like scheme (soap4-nt2.ini sets
BWALikeScore=1): bwase g_log_n table (CPUfunctions.h:104-109,
SOAP4.cpp:291), bwaLikeSingleQualScore and bwaLikePairQualScore
(BGS-IO.cpp:710-728, 814-877) on per-end best/second-best hit counts
and pair-level optimal/suboptimal scores.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, TextIO, Tuple

import numpy as np

from megapath.align.engine import BatchHits
from megapath.index.pack import COMPLEMENT, PackedReference, decode_seq
from megapath.ops.dp import DPParams

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAP = 0x4
FLAG_MUNMAP = 0x8
FLAG_REVERSE = 0x10
FLAG_MREVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100


def sam_header(ref: PackedReference, prog: str = "megapath") -> str:
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    lens = np.diff(ref.offsets)
    for name, ln in zip(ref.names, lens):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(ln)}")
    lines.append(f"@PG\tID:{prog}\tPN:{prog}")
    return "\n".join(lines) + "\n"


# bwase_initialize (CPUfunctions.h:104-109): g_log_n[i] = 4.343*ln(i)+.5
_G_LOG_N = np.zeros(256, dtype=np.int64)
_G_LOG_N[1:] = (4.343 * np.log(np.arange(1, 256)) + 0.5).astype(np.int64)


def bwa_single_mapq(x0: int, x1: int) -> int:
    """bwaLikeSingleQualScore (BGS-IO.cpp:710-728): x0 = optimal hit
    count, x1 = suboptimal hit count."""
    if x0 > 1:
        return 0
    if x1 == 0:
        return 37
    n = int(_G_LOG_N[min(x1, 255)])
    return 0 if n > 23 else 23 - n


def bwa_pair_mapq(
    x0_0: int, x1_0: int, x0_1: int, x1_1: int,
    op_score: int, op_num: int, subop_score: int, subop_num: int,
    readlen_0: int, readlen_1: int,
) -> Tuple[int, int]:
    """bwaLikePairQualScore (BGS-IO.cpp:814-877). op/subop are pair
    total DP scores (scaled x10 internally, as the reference does)."""
    mapq0 = bwa_single_mapq(x0_0, x1_0)
    mapq1 = bwa_single_mapq(x0_1, x1_1)
    op_score *= 10
    subop_score *= 10
    if mapq0 > 0 and mapq1 > 0:
        mapq_p = min(mapq0 + mapq1, 60)
        return mapq_p, mapq_p
    mapq_p = 0
    if op_num == 1:
        if subop_num == 0:
            mapq_p = 29
        elif op_score - subop_score > 0.3 * ((readlen_0 + readlen_1) / 2):
            mapq_p = 23
        else:
            mapq_p = max(
                0,
                (op_score - subop_score) // 2 - int(_G_LOG_N[min(subop_num, 255)]),
            )
    if mapq0 == 0:
        mapq0 = min(mapq_p + 7, mapq1)
    if mapq1 == 0:
        mapq1 = min(mapq_p + 7, mapq0)
    return mapq0, mapq1


def _end_hit_counts(raws: List[int], starts: List[int]) -> Tuple[int, int]:
    """(x0, x1): counts of distinct-position hits at the best and
    second-best score tiers (BGS-IO.cpp:2332-2437 best/secBest scan)."""
    best = max(raws)
    x0 = len({s for r, s in zip(raws, starts) if r == best})
    rest = [r for r in raws if r < best]
    if not rest:
        return x0, 0
    second = max(rest)
    x1 = len({s for r, s in zip(raws, starts) if r == second})
    return x0, x1


def hits_to_sam(
    hits: BatchHits,
    ref: PackedReference,
    names: Sequence[str],
    reads1: np.ndarray,
    lens1: np.ndarray,
    reads2: np.ndarray,
    lens2: np.ndarray,
    quals1: Optional[Sequence[str]] = None,
    quals2: Optional[Sequence[str]] = None,
    params: DPParams = DPParams(),
    with_cigar: bool = True,
    max_secondary: int = 8,
) -> Iterable[str]:
    """Yield SAM alignment lines for every hit (best first per end)."""
    order = np.lexsort((-hits.score, hits.end, hits.read))
    by_read_end: Dict[Tuple[int, int], List[int]] = {}
    for idx in order:
        key = (int(hits.read[idx]), int(hits.end[idx]))
        by_read_end.setdefault(key, []).append(int(idx))

    # per-read MAPQ of the primary alignment (BWA-like scheme)
    primary_mapq: Dict[Tuple[int, int], int] = {}
    for r in {k[0] for k in by_read_end}:
        stats = {}
        for e in (0, 1):
            rows = by_read_end.get((r, e))
            if rows:
                stats[e] = _end_hit_counts(
                    [int(hits.raw_score[i]) for i in rows],
                    [int(hits.start[i]) for i in rows],
                )
        pair_rows = [
            i for e in (0, 1) for i in by_read_end.get((r, e), [])
            if hits.paired[i] and hits.end[i] == 0
        ]
        if len(stats) == 2 and pair_rows:
            pair_scores = sorted(
                (int(hits.score[i]) for i in pair_rows), reverse=True
            )
            op = pair_scores[0]
            op_num = sum(1 for s in pair_scores if s == op)
            subs = [s for s in pair_scores if s < op]
            subop = subs[0] if subs else 0
            subop_num = len(pair_scores) - op_num
            rl0 = int(lens1[r])
            rl1 = int(lens2[r])
            m0, m1 = bwa_pair_mapq(
                *stats[0], *stats[1], op, op_num, subop, subop_num, rl0, rl1
            )
            primary_mapq[(r, 0)], primary_mapq[(r, 1)] = m0, m1
        else:
            for e, (x0, x1) in stats.items():
                primary_mapq[(r, e)] = bwa_single_mapq(x0, x1)

    # emit plan: (r, e, rank, idx) per line, caps applied up front so
    # the CIGAR tracebacks batch into ONE vectorized call over all
    # emitted hits (sw_traceback_batch) instead of a per-hit Python DP
    plan = [
        (r, e, rank, idx)
        for (r, e), rows in by_read_end.items()
        for rank, idx in enumerate(rows[: 1 + max_secondary])
    ]
    cigars: Optional[List[str]] = None
    if with_cigar and plan:
        from megapath.ops.dp import sw_traceback_batch

        n = len(plan)
        rls = np.array(
            [int((lens1 if e == 0 else lens2)[r]) for r, e, _, _ in plan],
            np.int64,
        )
        spans = np.array(
            [int(hits.stop[idx] - hits.start[idx]) for _, _, _, idx in plan],
            np.int64,
        )
        Rm, Wm = int(rls.max()), int(spans.max())
        b_reads = np.zeros((n, Rm), np.uint8)
        b_wins = np.full((n, Wm), 255, np.uint8)  # never matches a code
        for k, (r, e, _, idx) in enumerate(plan):
            reads = reads1 if e == 0 else reads2
            codes = reads[r, : rls[k]]
            if int(hits.strand[idx]):
                codes = COMPLEMENT[codes[::-1]]
            b_reads[k, : rls[k]] = codes
            w0 = int(hits.start[idx])
            win = ref.codes[w0 : w0 + spans[k]]
            # a window can run past the packed text at a ref boundary;
            # the short tail stays 255 (never matches) instead of
            # aborting the whole batch on a shape mismatch
            b_wins[k, : len(win)] = win
            spans[k] = min(spans[k], len(win)) or 1
        try:
            _, sjs, cores, _ = sw_traceback_batch(
                b_reads, b_wins, spans, rls, params
            )
            cigars = [
                (f"{int(sj)}S" if int(sj) else "") + core
                for sj, core in zip(sjs, cores)
            ]
        except Exception:
            # degrade per row like the old scalar path: one pathological
            # hit falls back to '{rl}M' without aborting SAM emission
            cigars = []
            for k in range(n):
                try:
                    _, sj, core, _ = sw_traceback_batch(
                        b_reads[k : k + 1],
                        b_wins[k : k + 1],
                        spans[k : k + 1],
                        rls[k : k + 1],
                        params,
                    )
                    cigars.append(
                        (f"{int(sj[0])}S" if int(sj[0]) else "") + core[0]
                    )
                except Exception:
                    cigars.append(f"{int(rls[k])}M")

    for k, (r, e, rank, idx) in enumerate(plan):
        reads = reads1 if e == 0 else reads2
        lens = lens1 if e == 0 else lens2
        quals = quals1 if e == 0 else quals2
        rl = int(lens[r])
        codes = reads[r, :rl]
        qual = quals[r] if quals is not None else "I" * rl
        strand = int(hits.strand[idx])
        seq_idx = int(hits.seq[idx])
        local_start = int(hits.start[idx] - ref.offsets[seq_idx])
        flag = FLAG_PAIRED | (FLAG_READ1 if e == 0 else FLAG_READ2)
        if strand:
            flag |= FLAG_REVERSE
        if hits.paired[idx]:
            flag |= FLAG_PROPER
        if rank > 0:
            flag |= FLAG_SECONDARY

        oriented = COMPLEMENT[codes[::-1]] if strand else codes
        cigar = cigars[k] if cigars is not None else f"{rl}M"
        mapq = primary_mapq[(r, e)] if rank == 0 else 0
        yield "\t".join(
            [
                names[r],
                str(flag),
                ref.names[seq_idx],
                str(local_start + 1),  # SAM is 1-based
                str(mapq),
                cigar,
                "*",
                "0",
                "0",
                decode_seq(oriented),
                qual if not strand else qual[::-1],
                f"AS:i:{int(hits.raw_score[idx])}",
            ]
        )


def write_sam(
    out: TextIO,
    hits: BatchHits,
    ref: PackedReference,
    names: Sequence[str],
    reads1: np.ndarray,
    lens1: np.ndarray,
    reads2: np.ndarray,
    lens2: np.ndarray,
    **kw,
) -> None:
    out.write(sam_header(ref))
    for line in hits_to_sam(
        hits, ref, names, reads1, lens1, reads2, lens2, **kw
    ):
        out.write(line + "\n")
