"""Kraken/Pavian-style taxonomic report.

Byte-parity equivalent of /root/reference/cc/genKrakenReport.cpp: per read,
the LCA of its hit taxids is counted; clade counts accumulate up the
lineage; the table is a DFS from the root with children sorted by
descending clade count. Reads scoring below the threshold are
unclassified.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Set, TextIO

import numpy as np

from megapath.io.lsam import LsamRecord, parse_hits
from megapath.taxonomy.taxdb import TaxDB

_ROOT = -2  # virtual super-root marker (genKrakenReport.cpp:16)


def _sanitize(name: str) -> str:
    """Pavian chokes on single quotes; drop them (genKrakenReport.cpp:31-38)."""
    return name.replace("'", "")


class KrakenReport:
    """Accumulates per-read LCA counts and prints the report table."""

    def __init__(self, db: TaxDB):
        self.db = db
        self.total_reads = 0
        self.tid_count: Dict[int, int] = defaultdict(int)  # n-stay
        self.tid_acc_count: Dict[int, int] = defaultdict(int)  # n-clade
        self.sons: Dict[int, Set[int]] = defaultdict(set)

    # ------------------------------------------------------------------
    def add_read(self, tids: Sequence[int]) -> None:
        """Count one read by the LCA of its hit taxids. Empty => unclassified."""
        self.total_reads += 1
        if not tids:
            self.tid_count[0] += 1
            return
        lca = self.db.lca(list(tids))
        if lca == 0:
            lca = 1  # genKrakenReport.cpp:70
        self.tid_count[lca] += 1
        lineage: List[int] = []
        t = lca
        while t != 1 and t != 0:
            lineage.append(t)
            self.tid_acc_count[t] += 1
            t = int(self.db.parent[t]) if t < len(self.db.parent) else 0
        lineage.append(t)
        self.tid_acc_count[t] += 1
        for i in range(len(lineage) - 1):
            self.sons[lineage[i + 1]].add(lineage[i])
        self.sons[_ROOT].add(lineage[-1])

    def add_lsam_line(self, line: str, score_threshold: int = 40) -> None:
        """One LSAM.id line -> one read (genKrakenReport.cpp:148-156)."""
        cols = line.rstrip("\n").split("\t")
        score = int(float(cols[2])) if _is_num(cols[2]) else 0
        hits = cols[5] if score >= score_threshold else "*"
        self.add_read([int(float(t)) for _, t in parse_hits(hits)])

    def add_lsam_batch(self, scores: np.ndarray, lca_tids: np.ndarray,
                       score_threshold: int = 40) -> None:
        """Vectorized intake: precomputed per-read LCAs + scores.

        Lineage walks run once per distinct LCA with aggregated counts,
        not once per read."""
        ok = scores >= score_threshold
        for lca, c in zip(*np.unique(lca_tids[ok], return_counts=True)):
            self._count_lca(int(lca), int(c))
        self.tid_count[0] += int((~ok).sum())
        self.total_reads += len(scores)

    def _count_lca(self, lca: int, count: int = 1) -> None:
        if lca == 0:
            lca = 1
        self.tid_count[lca] += count
        lineage: List[int] = []
        t = lca
        while t != 1 and t != 0:
            lineage.append(t)
            self.tid_acc_count[t] += count
            t = int(self.db.parent[t]) if t < len(self.db.parent) else 0
        lineage.append(t)
        self.tid_acc_count[t] += count
        for i in range(len(lineage) - 1):
            self.sons[lineage[i + 1]].add(lineage[i])
        self.sons[_ROOT].add(lineage[-1])

    # ------------------------------------------------------------------
    def format(self) -> str:
        out: List[str] = []
        out.append("perc\tn-clade\tn-stay\tlevel\ttaxonid\tdepth\tname")
        u = self.tid_count[0]
        total = self.total_reads if self.total_reads else 1
        out.append(
            f"{u * 100.0 / self.total_reads:6.2f}\t{u}\t{u}\tU\t0\t0\tunclassified"
            if self.total_reads
            else f"{0.0:6.2f}\t0\t0\tU\t0\t0\tunclassified"
        )
        self._format_subtree(1, 0, out)
        return "\n".join(out) + "\n"

    def _format_subtree(self, tid: int, depth: int, out: List[str]) -> None:
        if tid >= 0 and (tid & 0xC0000000) == 0:
            acc = self.tid_acc_count[tid]
            stay = self.tid_count[tid]
            rank_c = chr(self.db.rank_code[tid]) if tid < len(self.db.rank_code) else "-"
            name = _sanitize(self.db.name_of(tid))
            pct = acc * 100.0 / (self.total_reads or 1)
            out.append(
                f"{pct:6.2f}\t{acc}\t{stay}\t{rank_c}\t{tid}\t{depth}\t"
                + "  " * depth
                + name
            )
        # children sorted by descending clade count; ties keep ascending
        # tid order (std::set iteration + comparator in cmp_)
        kids = sorted(self.sons.get(tid, ()), key=lambda t: -self.tid_acc_count[t])
        for k in kids:
            self._format_subtree(k, depth + 1, out)

    def write(self, fp: TextIO) -> None:
        fp.write(self.format())


def _is_num(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def gen_kraken_report(db: TaxDB, lsam_id_lines: Iterable[str],
                      score_threshold: int = 40) -> str:
    """Functional one-shot equivalent of the genKrakenReport tool."""
    rpt = KrakenReport(db)
    for line in lsam_id_lines:
        if line.strip():
            rpt.add_lsam_line(line, score_threshold)
    return rpt.format()


def japsa_to_kraken(
    db: TaxDB,
    lines,
    taxid_col: int = 4,
    aligned_col: int = 8,
    delimiter: str = "\t",
) -> str:
    """Japsa nanopore species-typing TSV -> Kraken-style report.

    Mirrors /root/reference/cc/Japsa/genKrakenReportFromJapsaOutput.cpp:
    column ``taxid_col`` holds the taxid, ``aligned_col`` the aligned
    read count; counts accumulate up the lineage and print in the same
    table shape as genKrakenReport.
    """
    rpt = KrakenReport(db)
    first = True
    for line in lines:
        if first:  # header row
            first = False
            continue
        cols = line.rstrip("\n").split(delimiter)
        if len(cols) <= max(taxid_col, aligned_col):
            continue
        try:
            tid = int(float(cols[taxid_col]))
            n = int(float(cols[aligned_col]))
        except ValueError:
            continue
        for _ in range(max(n, 0)):
            rpt._count_lca(tid)
            rpt.total_reads += 1
    return rpt.format()
