"""Alignment parity vs the reference soap4 on a synthetic genome.

Golden cfq produced by the reference aligner (make_align_fixtures.py);
our engine must reproduce the per-read best scores and hit sets.
"""

import collections
import pathlib

import numpy as np
import pytest

from megapath.align import AlignEngine, AlignParams, best_per_seq
from megapath.align.output import format_comment
from megapath.index.fm import build_fm_index
from megapath.index.pack import pack_fasta_file, pack_reads
from megapath.io.fastq import read_fastx, trim_readno

FIX = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def parity_world():
    ref = pack_fasta_file(FIX / "align_genome.fa")
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
    params = AlignParams()  # NT-stage defaults: -u 750 -top 95, mode -F
    engine = AlignEngine(ref, fm, params)

    r1 = list(read_fastx(FIX / "align_r1.fq"))
    r2 = list(read_fastx(FIX / "align_r2.fq"))
    reads1, lens1 = pack_reads([r.seq for r in r1], 80)
    reads2, lens2 = pack_reads([r.seq for r in r2], 80)
    hits = engine.align_pairs(reads1, lens1, reads2, lens2)
    table = best_per_seq(hits, len(r1), params.megapath_mode)

    golden = {}
    recs = list(read_fastx(FIX / "align_golden.cfq"))
    seen = collections.Counter()
    for rec in recs:
        name = trim_readno(rec.name)
        end = seen[name]
        seen[name] += 1
        golden[(name, end)] = rec
    return ref, params, engine, r1, table, golden


def _parse_hits(comment: str):
    """SCORE comment -> (best, {name: score})."""
    assert comment.startswith("SCORE:")
    segs = comment[6:].split(";")
    best = int(segs[0])
    hits = {}
    for seg in segs[1:]:
        if not seg:
            continue
        sc, name = seg.split(",", 1)
        hits[name] = max(hits.get(name, 0), int(sc))
    return best, hits


def test_parity_best_scores(parity_world):
    ref, params, engine, r1, table, golden = parity_world
    mismatch = []
    for i, rec in enumerate(r1):
        name = trim_readno(rec.name)
        for end in (0, 1):
            want_best, want_hits = _parse_hits(golden[(name, end)].comment)
            mine = format_comment(table[end][i], ref, params)
            got_best, got_hits = _parse_hits(mine)
            if got_best != want_best or got_hits != want_hits:
                mismatch.append((name, end, want_best, got_best, want_hits, got_hits))
    frac = len(mismatch) / (2 * len(r1))
    assert frac == 0, (
        f"{len(mismatch)}/{2*len(r1)} read-ends mismatch: {mismatch[:10]}"
    )
