"""Protein-remap and contaminant-cleanup toolchain equivalents.

- m8_to_lsam:   DIAMOND blastx m8 -> LSAM (/root/reference/m8_to_lsam.pl)
- r2c_to_r2g:   read->contig LSAM x contig->genome LSAM -> read->genome
                (/root/reference/r2c_to_r2g.pl transitive hit join)
- cleanup:      contaminant (human/synthetic) homolog species removal
                (/root/reference/cc/cleanup.cpp; present in the
                reference but commented out of its driver)
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from megapath.io.lsam import LsamRecord, parse_hits, _fmt_score


def m8_to_lsam(lines: Iterable[str]) -> Iterator[LsamRecord]:
    """DIAMOND m8 rows -> LSAM records (one per query, merged hits).

    m8 columns: qseqid sseqid pident len mm go qs qe ss se evalue
    bitscore; the reference variant carries taxids joined by the
    LITERAL text "0x1" in col 2 and takes the max bitscore (col 12) as
    the score (m8_to_lsam.pl:20-45).
    """
    cur: Optional[str] = None
    hits: List[Tuple[float, str]] = []

    def flush():
        nonlocal cur, hits
        if cur is not None:
            best = max((s for s, _ in hits), default=0)
            yield LsamRecord(
                name=cur, flag=0, score=int(best), seq="*", qual="*", hits=hits
            )
        cur, hits = None, []

    for line in lines:
        cols = line.rstrip("\n").split("\t")
        if len(cols) < 12:
            continue
        q, s, bit = cols[0], cols[1], float(cols[11])
        if q != cur:
            yield from flush()
            cur = q
        for tid in s.split("0x1"):
            hits.append((bit, tid))
    yield from flush()


def r2c_to_r2g(
    read2contig: Iterable[LsamRecord],
    contig2genome: Iterable[LsamRecord],
    threshold: float = 40.0,
) -> Iterator[LsamRecord]:
    """Transitive join: read->contig hits x contig->genome hits.

    Byte-faithful to r2c_to_r2g.pl: contig records named
    ``contig_<id>`` register their RAW hit-label string under ``<id>``;
    each read's contig hits with read-side score > threshold append the
    contig's whole label string; seq/qual become ``*`` and read opts
    pass through. Reads tagged IGNORE are dropped entirely. Unaligned
    contigs (label ``*``) contribute nothing (the Perl would push the
    literal ``*``, which no downstream consumer can parse).
    """
    c2g: Dict[str, str] = {}
    for rec in contig2genome:
        if rec.name.startswith("contig_") and len(rec.name) > 7:
            c2g[rec.name[7:]] = rec.hits_str()

    for rec in read2contig:
        if "IGNORE" in rec.opts:
            continue
        labels = [
            c2g[ctg]
            for score, ctg in rec.hits
            if score > threshold and ctg in c2g and c2g[ctg] != "*"
        ]
        yield LsamRecord(
            name=rec.name,
            flag=rec.flag,
            score=rec.score,
            seq="*",
            qual="*",
            hits=parse_hits(";".join(labels)) if labels else [],
            opts=rec.opts,
        )


def extract_from_lsam(
    records: Iterable[LsamRecord],
    threshold: float,
    viral: bool = False,
    se_mode: bool = False,
    append_ignore: bool = False,
    skip_ignore_tag: bool = False,
) -> Iterator[Tuple[LsamRecord, int, str]]:
    """Select reads from consecutive-pair LSAM, per extractFromLSAM.pl.

    Yields (record, mate 1|2, comment) for each read to keep: the pair
    is selected when either end scores below the cutoff (fractional
    thresholds scale by the pair length, extractFromLSAM.pl:67) or
    ``viral`` and an end carries the Viruses superkingdom column; in
    ``se_mode`` each selected end must itself be under the cutoff (or
    viral). ``append_ignore`` marks over-cutoff mates with an IGNORE
    comment; ``skip_ignore_tag`` drops ends already tagged IGNORE.
    """
    it = iter(records)
    for r1 in it:
        r2 = next(it, None)
        if r2 is None:
            break
        cut = (
            threshold * (len(r1.seq) + len(r2.seq))
            if threshold < 1
            else threshold
        )
        v1 = "Viruses" in r1.opts
        v2 = "Viruses" in r2.opts
        if not (r1.score < cut or r2.score < cut or (viral and (v1 or v2))):
            continue
        for rec, which, v in ((r1, 1, v1), (r2, 2, v2)):
            if skip_ignore_tag and "IGNORE" in rec.opts:
                continue
            if se_mode and not (rec.score < cut or v):
                continue
            comment = "IGNORE" if append_ignore and rec.score >= cut else ""
            yield rec, which, comment


def cleanup_contaminants(
    records: List[LsamRecord],
    contaminant_tids: Set[int] = frozenset({9606, 32630}),
    score_tolerance: float = 10.0,
    fraction: float = 0.5,
) -> Tuple[List[LsamRecord], Set[int]]:
    """Remove species explained by contaminants (cleanup.cpp:35-136).

    A species is contaminant-explained when >= ``fraction`` of its
    reads carry a contaminant hit scoring within ``score_tolerance`` of
    the species hit. Returns (rewritten records, removed species set).
    """
    total: Dict[int, int] = defaultdict(int)
    close: Dict[int, int] = defaultdict(int)
    for rec in records:
        tids = {int(float(t)): s for s, t in rec.hits}
        cont_best = max(
            (s for t, s in tids.items() if t in contaminant_tids), default=None
        )
        for t, s in tids.items():
            if t in contaminant_tids:
                continue
            total[t] += 1
            if cont_best is not None and s <= cont_best + score_tolerance:
                close[t] += 1

    removed = {
        t for t in total if total[t] > 0 and close[t] >= fraction * total[t]
    }

    out: List[LsamRecord] = []
    for rec in records:
        kept = [
            (s, t) for s, t in rec.hits if int(float(t)) not in removed
        ]
        out.append(
            LsamRecord(
                rec.name, rec.flag, rec.score, rec.seq, rec.qual, kept, rec.opts
            )
        )
    return out, removed


def japsa_to_kraken_report(
    taxdb,
    lines: "Iterable[str]",
    taxid_index: int = 4,
    aligned_index: int = 8,
) -> str:
    """Japsa nanopore species-typing TSV -> Kraken-style report
    (cc/Japsa/genKrakenReportFromJapsaOutput.cpp — not in the reference
    Makefile, kept for surface completeness). First line is a header;
    each row contributes its 'aligned' count at its taxid, clade counts
    accumulate up the lineage, and rows print DFS (children by clade
    count descending; ties broken by taxid — the C++ uses an unstable
    sort over unordered_set, so tie order there is unspecified)."""
    clade = {}
    stay = {}
    children = {}
    tot = 0
    it = iter(lines)
    next(it, None)  # header
    for line in it:
        cols = line.rstrip("\n").split("\t")
        if len(cols) <= max(taxid_index, aligned_index):
            continue
        tid = int(cols[taxid_index])
        aligned = int(float(cols[aligned_index]))
        stay[tid] = aligned  # assignment, like the C++ (last row wins)
        tot += aligned
        clade[tid] = clade.get(tid, 0) + aligned
        t = tid
        while t not in (0, 1):
            p = int(taxdb.parent[t]) if t < len(taxdb.parent) else 0
            children.setdefault(p, set()).add(t)
            t = p
            clade[t] = clade.get(t, 0) + aligned

    RANKS = ("domain", "kingdom", "phylum", "class", "order", "family",
             "genus", "species")

    def level_code(tid: int) -> str:
        r = taxdb.rank_of(tid)
        if r == "superkingdom":
            return "D"
        return r[0].upper() if r in RANKS else "-"

    out = ["prec\tn-clade\tn-stay\tlevel\ttaxonid\tdepth\tname"]

    def emit(tid: int, depth: int) -> None:
        prec = (clade.get(tid, 0) * 100) / tot if tot else 0.0
        name = "unclassified" if tid == 0 else taxdb.name_of(tid)
        out.append(
            f"{prec:.2f}\t{clade.get(tid, 0)}\t{stay.get(tid, 0)}\t"
            f"{level_code(tid) if tid else '-'}\t{tid}\t{depth - 1}\t"
            + "  " * depth + name
        )
        kids = sorted(
            children.get(tid, ()), key=lambda t: (-clade.get(t, 0), t)
        )
        for k in kids:
            emit(k, depth + 1)

    emit(0, 1)
    emit(1, 1)
    return "\n".join(out) + "\n"


def filter_cross_family_reads(
    taxdb, records: "Iterable[LsamRecord]", level: str = "family"
):
    """LSAM -> FASTQ records of reads whose hits agree at ``level``
    (cc/filterCrossFamilyReads.cpp): each hit accession's taxid pops
    up to the level (falling back to the last species seen when the
    walk tops out, popUpToLevel :127-136); reads whose popped-taxid
    set has more than one member are cross-family artifacts and are
    dropped. Yields (name, seq, qual) FastqRecords like the C++'s
    4-line output."""
    from megapath.io.fastq import FastqRecord
    from megapath.taxonomy.taxdb import get_accession, remove_version

    for rec in records:
        tax = set()
        for _, acc in rec.hits:
            a = remove_version(get_accession(str(acc)))
            tid = taxdb.acc2tid.get(a)
            if tid is None:
                continue
            sp_id = tid
            t = tid
            while t not in (0, 1) and taxdb.rank_of(t) != level:
                if taxdb.rank_of(t) == "species":
                    sp_id = t
                t = int(taxdb.parent[t]) if t < len(taxdb.parent) else 0
            tax.add(sp_id if t <= 1 else t)
        if len(tax) <= 1:
            yield FastqRecord(rec.name, rec.seq, rec.qual)
