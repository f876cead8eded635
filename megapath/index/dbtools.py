"""Offline reference-DB construction utilities.

Compact equivalents of the reference's cc/ DB tools
(/root/reference/cc/: maskLowerWithN, mask_with_N, filterExistingSeq,
ribosomeDedup, prepareKrakenFasta, splitFasta via index.shard).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

from megapath.io.fastq import FastqRecord, read_fastx


def mask_lowercase_with_n(rec: FastqRecord) -> FastqRecord:
    """Soft-masked (lowercase) bases -> N (maskLowerWithN)."""
    seq = "".join("N" if c.islower() else c for c in rec.seq)
    return FastqRecord(rec.name, seq, rec.qual, rec.comment)


def mask_intervals_with_n(
    rec: FastqRecord, intervals: Sequence[Tuple[int, int]]
) -> FastqRecord:
    """Mask [start, end) intervals to N (mask_with_N over a bed)."""
    s = list(rec.seq)
    for a, b in intervals:
        for i in range(max(0, a), min(len(s), b)):
            s[i] = "N"
    return FastqRecord(rec.name, "".join(s), rec.qual, rec.comment)


def filter_existing(
    records: Iterable[FastqRecord], existing_names: Set[str]
) -> Iterator[FastqRecord]:
    """Drop sequences whose accession is already present
    (filterExistingSeq)."""
    for rec in records:
        if rec.name.split(".")[0] not in existing_names:
            yield rec


def dedup_sequences(records: Iterable[FastqRecord]) -> Iterator[FastqRecord]:
    """Exact-sequence dedup, keeping the first occurrence
    (ribosomeDedup)."""
    seen: Set[bytes] = set()
    for rec in records:
        h = hashlib.sha1(rec.seq.encode()).digest()
        if h not in seen:
            seen.add(h)
            yield rec


def prepare_kraken_fasta(
    records: Iterable[FastqRecord], acc2tid: Dict[str, int]
) -> Iterator[FastqRecord]:
    """Prefix headers with kraken:taxid|NNN| (prepareKrakenFasta)."""
    for rec in records:
        tid = acc2tid.get(rec.name.split(".")[0])
        name = f"kraken:taxid|{tid}|{rec.name}" if tid else rec.name
        yield FastqRecord(name, rec.seq, rec.qual, rec.comment)


def split_ref_to_reads(
    records: Iterable[FastqRecord], read_len: int, overlap: int
) -> Iterator[FastqRecord]:
    """Chop reference sequences into overlapping pseudo-reads
    (/root/reference/cc/split_ref_to_reads.cpp): windows step by
    ``overlap`` with a final window flushed to the sequence end; names
    get a ``_<offset>`` suffix."""
    for rec in records:
        n = len(rec.seq)
        i = 0
        while True:
            if i + read_len > n:
                i = max(0, n - read_len)
            yield FastqRecord(
                f"{rec.name}_{i}", rec.seq[i : i + read_len], "", ""
            )
            if i + read_len >= n:
                break
            i += overlap


def revcomp_fastx(records: Iterable[FastqRecord]) -> Iterator[FastqRecord]:
    """Reverse-complement records (cc/revCompFastx.cpp); quality
    strings reverse alongside."""
    comp = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")
    for rec in records:
        yield FastqRecord(
            rec.name,
            rec.seq.translate(comp)[::-1],
            rec.qual[::-1] if rec.qual else "",
            rec.comment,
        )


def smart_pairing(
    records: Iterable[FastqRecord],
) -> Tuple[Iterator, list]:
    """Group a name-sorted stream into interleaved pairs + singles
    (cc/smart_pairing.cpp): consecutive same-name records pair up (/1
    /2 suffixes stripped), everything else is single-end. Returns
    (pairs list interleaved, singles list)."""
    from megapath.io.fastq import trim_readno

    pairs: list = []
    singles: list = []
    last: Optional[FastqRecord] = None
    for rec in records:
        rec.name = trim_readno(rec.name)
        if last is not None:
            if last.name == rec.name:
                pairs.extend((last, rec))
                last = None
            else:
                singles.append(last)
                last = rec
        else:
            last = rec
    if last is not None:
        singles.append(last)
    return pairs, singles


# ---------------------------------------------------------------------------
# DB construction: createDB / filterDB / selectSameSpecieGenome /
# surpiAnn2id (cc/createDB.cpp, cc/filterDB.cpp,
# cc/selectSameSpecieGenome.cc, cc/surpiAnn2id.cpp)
# ---------------------------------------------------------------------------


def header2acc(header: str) -> List[str]:
    """All accessions in a (possibly \\x01-concatenated) FASTA header,
    versions stripped (createDB.cpp:29-70). Handles gnl|uv| UniVec
    headers, old-style gi|..|xx|ACC| headers, and bare accessions."""
    from megapath.taxonomy.taxdb import remove_version

    out: List[str] = []
    if header.startswith("gnl|uv|"):
        end = header.find(":")
        return [remove_version(header[7 : end if end >= 0 else len(header)])]
    start = 0
    end = header.find("|")
    while start != -1:
        if end != -1 and header[start:end] == "gi":
            s1 = header.find("|", end + 1)
            s2 = header.find("|", s1 + 1)
            s3 = header.find("|", s2 + 1)
            out.append(remove_version(header[s2 + 1 : s3]))
            start = header.find("\x01", s3 + 1)
        else:
            end = start
            while (end < len(header) and not header[end].isspace()
                   and header[end] != "\x01" and header[end] != "|"):
                end += 1
            out.append(remove_version(header[start:end]))
            start = -1 if end == len(header) else header.find("\x01", end)
        if start == -1:
            return out
        start += 1
        end = header.find("|", start)
    return out


def _belongs_to(taxdb, acc: str, names) -> bool:
    tid = taxdb.acc2tid.get(acc, 0)
    while tid > 1:
        if taxdb.name_of(tid) in names:
            return True
        tid = int(taxdb.parent[tid])
    return False


def create_db(
    nt_records: Iterable[FastqRecord],
    uv_records: Iterable[FastqRecord],
    hg_records: Iterable[FastqRecord],
    taxdb,
) -> Iterator[FastqRecord]:
    """createDB: drop NCBI-nt sequences that are 'artificial sequences'
    or have no taxonomy mapping; append UniVec + human; reformat every
    header to the comma-joined accession list (createDB.cpp:95-140)."""
    for rec in nt_records:
        accs = header2acc(
            rec.name + (" " + rec.comment if rec.comment else "")
        )
        kept = [
            a for a in accs
            if taxdb.acc2tid.get(a) is not None
            and not _belongs_to(taxdb, a, ("artificial sequences",))
        ]
        if kept:
            yield FastqRecord(",".join(kept), rec.seq, "", "")
    for recs in (uv_records, hg_records):
        for rec in recs:
            accs = header2acc(
                rec.name + (" " + rec.comment if rec.comment else "")
            )
            if accs:
                yield FastqRecord(",".join(accs), rec.seq, "", "")


def filter_db(
    records: Iterable[FastqRecord], taxdb, tax_names: Sequence[str]
) -> Iterator[FastqRecord]:
    """filterDB: drop sequences whose ANY accession belongs to one of
    the named taxa (filterDB.cpp:80-108); others pass unchanged."""
    names = set(tax_names)
    for rec in records:
        accs = header2acc(
            rec.name + (" " + rec.comment if rec.comment else "")
        )
        if any(_belongs_to(taxdb, a, names) for a in accs):
            continue
        yield rec


def select_same_species_genome(
    records: Iterable[FastqRecord],
    taxdb,
    target_tids: Sequence[int],
    seed: int = 10086,
) -> List[FastqRecord]:
    """selectSameSpecieGenome: reservoir-sample ONE 'complete genome'
    per target species (tids popped to species rank,
    selectSameSpecieGenome.cc:31-60)."""
    import random

    from megapath.taxonomy.taxdb import get_correct_acc, remove_version

    rng = random.Random(seed)
    species = {}
    for t in target_tids:
        sp = taxdb.pop_to_species(int(t))
        if sp and sp not in species:
            species[sp] = None
    seen = {sp: 0 for sp in species}
    for rec in records:
        acc = remove_version(get_correct_acc(rec.name))
        tid = taxdb.pop_to_species(taxdb.acc2tid.get(acc, 0))
        if tid in species and "complete genome" in (rec.comment or ""):
            seen[tid] += 1
            if rng.randrange(seen[tid]) == 0:
                species[tid] = rec
    return [species[sp] for sp in species if seen[sp] > 0]


def surpi_ann2id(names_dmp_path, ann_lines: Iterable[str]) -> Iterator[str]:
    """surpiAnn2id: SURPI annotation -> 'acc<TAB>taxid' using the
    scientific-name table with spaces folded to '_'
    (surpiAnn2id.cpp:15-80)."""
    from megapath.io.fastq import open_maybe_gz

    name2tid = {}
    with open_maybe_gz(names_dmp_path, "rt") as f:
        for line in f:
            if "scientific name" not in line:
                continue
            parts = [p.strip() for p in line.split("|")]
            name2tid[parts[1].replace(" ", "_")] = int(parts[0])
    for line in ann_lines:
        cols = line.rstrip("\n").split("\t")
        acc = cols[0]
        h = acc.rfind("#")
        if h >= 0:
            acc = acc[:h]
        tid = 0
        for c in cols[1:]:
            if c.startswith("species--"):
                tid = name2tid.get(
                    c[9:].strip().replace(" ", "_").replace("\t", "_"), 0
                )
                break
        yield f"{acc}\t{tid}"


def kraken_censtruct(
    records: Iterable[FastqRecord],
    seqid2taxid: Optional[Dict[str, int]] = None,
    taxid: Optional[int] = None,
) -> Iterator[FastqRecord]:
    """kraken-censtruct: rewrite headers to NAME|kraken:taxid|N
    (cc/kraken-censtruct.cpp:51-64); sequences without a mapping are
    dropped with a warning, matching the reference's stderr skip."""
    import sys

    if (seqid2taxid is None) == (taxid is None):
        raise ValueError("pass exactly one of seqid2taxid / taxid")
    for rec in records:
        if taxid is not None:
            tid = taxid
        else:
            tid = seqid2taxid.get(rec.name)
            if tid is None:
                print(
                    f"Error: cannot find taxid for {rec.name}",
                    file=sys.stderr,
                )
                continue
        yield FastqRecord(f"{rec.name}|kraken:taxid|{tid}", rec.seq, "", "")


def extract_region(ref, name: str, start: int, end: int) -> str:
    """showGene: pull [start, end) of one reference sequence from the
    packed index (cc/showGene.cpp + indexFunction.cpp, which walk the
    .tra/.ann/.pac files; PackedReference holds the same data)."""
    from megapath.index.pack import decode_seq

    idx = list(ref.names).index(name)
    off = int(ref.offsets[idx])
    seq_len = int(ref.offsets[idx + 1]) - off
    start = max(0, min(start, seq_len))
    end = max(start, min(end, seq_len))
    return decode_seq(ref.codes[off + start : off + end])
