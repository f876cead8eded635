"""Two-pass "A explains B" read reassignment over LSAM.id.

Byte-parity equivalent of /root/reference/cc/reassign.cpp: pass 1 counts,
per taxon, total reads, unique reads, and pairwise co-occurrence (only
reads with score >= t). Taxon A *weakly explains* B iff

    uniq[A] > u * uniq[B]  and  counts[A] - intersect(A,B) > v * counts[A]

(u=20, v=0.05 default). A's explanation stands only if A itself is not
weakly explained. Pass 2 deletes explained taxa from every read's hit
list. The counting pass is pure segment arithmetic; this implementation
keeps it vectorizable numpy-side while matching the reference's output
bytes (sequences are masked to '*' unless output_seq).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, Optional, Set, TextIO, Tuple

from megapath.io.lsam import parse_hits


class Reassigner:
    def __init__(self, u: float = 20.0, v: float = 0.05, t: float = 40.0):
        self.u = u
        self.v = v
        self.t = t
        self.counts: Dict[int, int] = defaultdict(int)
        self.uniq_counts: Dict[int, int] = defaultdict(int)
        self.intersect: Dict[Tuple[int, int], int] = defaultdict(int)
        self.explains: Set[Tuple[int, int]] = set()

    @staticmethod
    def _pairup(t1: int, t2: int) -> Tuple[int, int]:
        """Unordered pair key, larger first (reassign.cpp:30-33)."""
        return (t1, t2) if t1 >= t2 else (t2, t1)

    # -- pass 1 ---------------------------------------------------------
    def count_line(self, line: str) -> None:
        cols = line.rstrip("\n").split("\t")
        hits = parse_hits(cols[5])
        try:
            score = float(cols[2])
        except ValueError:
            score = 0.0
        if score < self.t or not hits:
            return
        seen: List[int] = []
        for _, tgt in hits:
            tid = int(float(tgt))
            self.counts[tid] += 1
            if len(hits) == 1:
                self.uniq_counts[tid] += 1
            else:
                for prev in seen:
                    self.intersect[self._pairup(prev, tid)] += 1
            seen.append(tid)

    def count_hits(self, per_read_tids: Iterable[List[int]],
                   per_read_scores: Iterable[float]) -> None:
        """Array-path intake used by the pipeline (same arithmetic)."""
        for tids, score in zip(per_read_tids, per_read_scores):
            if score < self.t or not tids:
                continue
            for i, tid in enumerate(tids):
                self.counts[tid] += 1
                if len(tids) == 1:
                    self.uniq_counts[tid] += 1
                else:
                    for prev in tids[:i]:
                        self.intersect[self._pairup(prev, tid)] += 1

    def count_grouped(
        self,
        sp_rows,
        gid_rows,
        line_scores,
    ) -> None:
        """Vectorized pass 1 over hit rows sorted by line (group) id.

        ``sp_rows``/``gid_rows`` are per-hit species and line ids (rows
        sorted by gid, species deduped per line like taxLookupAcc
        output); ``line_scores[g]`` is the line's score column. Same
        arithmetic as count_line (reassign.cpp:80-117) without
        formatting each record to text and re-parsing it.
        """
        import numpy as np

        line_scores = np.asarray(line_scores)
        ok = (line_scores >= self.t)[gid_rows]
        g = np.asarray(gid_rows)[ok]
        s = np.asarray(sp_rows, dtype=np.int64)[ok]
        if len(s) == 0:
            return
        for tid, c in zip(*np.unique(s, return_counts=True)):
            self.counts[int(tid)] += int(c)
        first = np.r_[True, g[1:] != g[:-1]]
        starts = np.flatnonzero(first)
        sizes = np.diff(np.r_[starts, len(g)])
        for tid, c in zip(
            *np.unique(s[starts[sizes == 1]], return_counts=True)
        ):
            self.uniq_counts[int(tid)] += int(c)
        # pairwise co-occurrence: all unordered pairs within a line,
        # one vectorized round per pair distance
        maxk = int(sizes.max(initial=0))
        for d in range(1, maxk):
            i = np.arange(len(g) - d)
            m = g[i] == g[i + d]
            a, b = s[i[m]], s[i[m] + d]
            hi, lo = np.maximum(a, b), np.minimum(a, b)
            key = hi << 32 | lo
            for k, c in zip(*np.unique(key, return_counts=True)):
                self.intersect[(int(k >> 32), int(k & 0xFFFFFFFF))] += int(c)

    def explained_rows(self, sp_rows, gid_rows, n_groups: int):
        """Vectorized pass 2 mask: True for hit rows deleted because a
        co-occurring taxon explains them (reassign.cpp:190-203)."""
        import numpy as np

        sp_rows = np.asarray(sp_rows, dtype=np.int64)
        gid_rows = np.asarray(gid_rows)
        drop = np.zeros(len(sp_rows), dtype=bool)
        for a, b in self.explains:
            has_a = np.zeros(n_groups, dtype=bool)
            has_a[gid_rows[sp_rows == a]] = True
            drop |= (sp_rows == b) & has_a[gid_rows]
        return drop

    # -- resolve --------------------------------------------------------
    def _weakly_explain(self, a: int, b: int) -> bool:
        if self.uniq_counts[a] <= self.u * self.uniq_counts[b]:
            return False
        if (
            self.counts[a] - self.intersect[self._pairup(a, b)]
            <= self.v * self.counts[a]
        ):
            return False
        return True

    def resolve(self, log: Optional[TextIO] = None) -> Set[Tuple[int, int]]:
        """Compute the final (A, B) 'A explains B' set (reassign.cpp:129-154)."""
        weakly_explained: Set[int] = set()
        pairs = list(self.intersect.keys())
        for t1, t2 in pairs:
            if self._weakly_explain(t1, t2):
                weakly_explained.add(t2)
            elif self._weakly_explain(t2, t1):
                weakly_explained.add(t1)
        self.explains.clear()
        for t1, t2 in pairs:
            if self._weakly_explain(t1, t2):
                if t1 not in weakly_explained:
                    self.explains.add((t1, t2))
                    if log is not None:
                        log.write(f"{t1} explains {t2}\n")
            elif self._weakly_explain(t2, t1):
                if t2 not in weakly_explained:
                    self.explains.add((t2, t1))
                    if log is not None:
                        log.write(f"{t2} explains {t1}\n")
        return self.explains

    # -- pass 2 ---------------------------------------------------------
    def rewrite_line(self, line: str, output_seq: bool = False) -> str:
        cols = line.rstrip("\n").split("\t")
        hits = [(s, int(float(t))) for s, t in parse_hits(cols[5])]
        if not output_seq:
            cols[3] = cols[4] = "*"
        out = cols[:5]

        kept: List[str] = []
        for score, tid in hits:
            if any((other, tid) in self.explains for _, other in hits):
                continue
            # to_string((long long)double) truncation (reassign.cpp:201)
            kept.append(f"{int(score)},{tid}")
        if hits:
            out.append(";".join(kept))  # may be empty string, like the ref
        else:
            out.append("*")
        out.extend(cols[6:])
        return "\t".join(out)


def reassign_lines(lines: List[str], u: float = 20.0, v: float = 0.05,
                   t: float = 40.0, output_seq: bool = False,
                   log: Optional[TextIO] = None) -> Iterator[str]:
    """One-shot functional equivalent of the reassign tool."""
    ra = Reassigner(u=u, v=v, t=t)
    for line in lines:
        if line.strip():
            ra.count_line(line)
    ra.resolve(log)
    for line in lines:
        if line.strip():
            yield ra.rewrite_line(line, output_seq)
