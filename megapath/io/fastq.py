"""FASTQ / FASTA / annotated-FASTQ ("cfq") host-side IO.

The reference pipeline streams FASTQ between stages, carrying cumulative
alignment results in the read *comment* as ``SCORE:<best>;<score>,<ref>;...``
(see /root/reference/soap4/BGS-IO.cpp:1348 getMappingFromHeader and
:1966 pairDeepDPOutputFastqAPI). This module provides the equivalent
record model and streaming readers/writers. Parsing is plain Python —
these run on the host feeding the device pipeline; the hot path operates
on packed numpy/JAX arrays produced by ``megapath.index.pack``.
"""

from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Tuple


def open_maybe_gz(path, mode: str = "rt"):
    """Open ``path`` transparently whether or not it is gzip-compressed.

    ``path`` may also be a file object (returned unchanged) or ``"-"``
    for stdin/stdout.
    """
    if hasattr(path, "read") or hasattr(path, "write"):
        return path
    path = str(path)
    if path == "-":
        import sys

        return sys.stdin if "r" in mode else sys.stdout
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def trim_readno(name: str) -> str:
    """Strip a trailing ``/1`` or ``/2`` (any digit) pair-end suffix.

    Mirrors trim_readno in /root/reference/cc/fastq2lsam.cpp:14-17.
    """
    if len(name) > 2 and name[-2] == "/" and name[-1].isdigit():
        return name[:-2]
    return name


@dataclass
class FastqRecord:
    """One FASTQ/FASTA record. ``comment`` is the post-name header text."""

    name: str
    seq: str
    qual: str = ""  # empty => FASTA
    comment: str = ""

    # -- cfq comment helpers ------------------------------------------------
    @property
    def score(self) -> Optional[int]:
        """Best score carried in a ``SCORE:`` comment, -1 for IGNORE."""
        if self.comment == "IGNORE":
            return -1
        if self.comment.startswith("SCORE:"):
            head = self.comment[6:].split(";", 1)[0]
            try:
                return int(head)
            except ValueError:
                return 0
        return None

    def hits(self) -> List[Tuple[int, str]]:
        """Parse ``SCORE:best;score,ref;score,ref;...`` -> [(score, ref)].

        A hit segment may name several refs: ``score,refA,refB`` expands to
        one hit per ref at that score (fastq2lsam.cpp:55-71 semantics).
        """
        if not self.comment.startswith("SCORE:"):
            return []
        out: List[Tuple[int, str]] = []
        parts = self.comment[6:].split(";")
        for seg in parts[1:]:
            if not seg:
                continue
            sub = seg.split(",")
            try:
                sc = int(float(sub[0]))
            except ValueError:
                continue
            for ref in sub[1:]:
                out.append((sc, ref))
        return out


def make_score_comment(best: int, hits: Iterable[Tuple[int, str]]) -> str:
    """Build a cfq ``SCORE:`` comment string (trailing ';' like soap4)."""
    segs = "".join(f"{s},{r};" for s, r in hits)
    return f"SCORE:{best};{segs}"


def read_fastx(path) -> Iterator[FastqRecord]:
    """Stream FASTQ or FASTA records (gz transparent, multiline FASTA ok)."""
    fp = open_maybe_gz(path, "rt")
    it = iter(fp)
    pushback: Optional[str] = None

    def nextline() -> Optional[str]:
        nonlocal pushback
        if pushback is not None:
            line, pushback = pushback, None
            return line
        try:
            return next(it)
        except StopIteration:
            return None

    while True:
        line = nextline()
        if line is None:
            return
        line = line.rstrip("\n")
        if not line:
            continue
        if line[0] == "@":  # FASTQ
            head = line[1:]
            name, _, comment = head.partition("\t")
            if "\t" not in head:
                name, _, comment = head.partition(" ")
            seq = (nextline() or "").rstrip("\n")
            _plus = nextline()
            qual = (nextline() or "").rstrip("\n")
            yield FastqRecord(name=name, seq=seq, qual=qual, comment=comment)
        elif line[0] == ">":  # FASTA (possibly multiline)
            head = line[1:]
            name, _, comment = head.partition("\t")
            if "\t" not in head:
                name, _, comment = head.partition(" ")
            chunks: List[str] = []
            while True:
                nl = nextline()
                if nl is None:
                    break
                if nl and nl[0] in ">@":
                    pushback = nl
                    break
                chunks.append(nl.rstrip("\n"))
            yield FastqRecord(name=name, seq="".join(chunks), qual="", comment=comment)
        else:
            raise ValueError(f"malformed FASTX line: {line[:80]!r}")


def write_fastq(records: Iterable[FastqRecord], path, sep: str = "\t") -> None:
    """Write FASTQ (or FASTA when qual empty). Comment joined by ``sep``.

    soap4's cfq output uses a tab between name and the SCORE comment
    (BGS-IO.cpp:2041-2046); deinterleave.cpp re-emits with a space.
    """
    fp = open_maybe_gz(path, "wt")
    close = not (hasattr(path, "write"))
    try:
        for r in records:
            head = r.name + (sep + r.comment if r.comment else "")
            if r.qual:
                fp.write(f"@{head}\n{r.seq}\n+\n{r.qual}\n")
            else:
                fp.write(f">{head}\n{r.seq}\n")
    finally:
        if close and fp is not path:
            fp.close()
