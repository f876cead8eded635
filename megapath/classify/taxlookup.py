"""LSAM -> LSAM.id: accession hits to species-level taxid hits.

Byte-parity equivalent of /root/reference/cc/taxLookupAcc.cpp: per hit,
look up the accession's taxid, pop up to the species rank, keep the max
score per species; append the sorted unique superkingdom names as extra
columns. Unknown accessions are dropped with a warning.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, Iterator, List, Optional, TextIO, Tuple

from megapath.io.lsam import parse_hits, _fmt_score
from megapath.taxonomy.taxdb import TaxDB, get_correct_acc, remove_version


def tax_lookup_line(db: TaxDB, line: str, warn: Optional[TextIO] = None) -> str:
    """Transform one LSAM line to LSAM.id (taxLookupAcc.cpp:54-93)."""
    cols = line.rstrip("\n").split("\t")
    out = cols[:5]

    tid_score: Dict[int, float] = {}
    for score, acc in parse_hits(cols[5]):
        acc = get_correct_acc(acc)
        tid = db.acc2tid.get(remove_version(acc))
        if tid is None:
            if warn is not None:
                warn.write(f"Error: Taxid not found for {acc}\n")
            continue
        sp = db.pop_to_species(tid)
        prev = tid_score.get(sp)
        if prev is None or score > prev:
            tid_score[sp] = score

    if not tid_score:
        out.append("*")
    else:
        # std::map iterates in ascending taxid order
        out.append(
            ";".join(
                f"{_fmt_score(s)},{t}" for t, s in sorted(tid_score.items())
            )
        )
    out.extend(cols[6:])

    # superkingdom names, sorted unique by taxid (taxLookupAcc.cpp:16-31)
    sks = sorted({db.superkingdom_of(t) for t in tid_score} - {0})
    out.extend(db.name_of(t) for t in sks)
    return "\t".join(out)


def tax_lookup_acc(db: TaxDB, lines: Iterable[str],
                   warn: Optional[TextIO] = None) -> Iterator[str]:
    for line in lines:
        if line.strip():
            yield tax_lookup_line(db, line, warn)
