"""SAM output tests."""

import io

import numpy as np

from megapath.align import AlignEngine, AlignParams, MmpParams
from megapath.index.fm import build_fm_index
from megapath.index.pack import COMPLEMENT, decode_seq, pack_fasta
from megapath.io.fastq import FastqRecord
from megapath.io.sam import sam_header, write_sam


def test_sam_output_roundtrip():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 5000).astype(np.uint8)
    ref = pack_fasta([FastqRecord("chrT", decode_seq(codes), "", "")])
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=6)
    params = AlignParams(
        insert_high=400,
        mmp=MmpParams(seed_min_length=12, reseed_len=13, good_seed_len=18),
    )
    engine = AlignEngine(ref, fm, params)

    n, L, ins = 4, 80, 300
    reads1 = np.zeros((n, L), np.uint8)
    reads2 = np.zeros((n, L), np.uint8)
    starts = []
    for b in range(n):
        p = 100 + 700 * b
        reads1[b] = codes[p : p + L]
        seg = codes[p + ins - L : p + ins]
        reads2[b] = COMPLEMENT[seg[::-1]]
        starts.append(p)
    lens = np.full(n, L, np.int32)
    hits = engine.align_pairs(reads1, lens, reads2, lens.copy())

    buf = io.StringIO()
    names = [f"rd{i}" for i in range(n)]
    write_sam(buf, hits, ref, names, reads1, lens, reads2, lens)
    text = buf.getvalue()
    lines = [l for l in text.splitlines() if not l.startswith("@")]
    assert len(lines) >= 2 * n
    hdr = [l for l in text.splitlines() if l.startswith("@SQ")]
    assert hdr == ["@SQ\tSN:chrT\tLN:5000"]

    by_name = {}
    for l in lines:
        f = l.split("\t")
        by_name.setdefault(f[0], []).append(f)
    for b in range(n):
        recs = by_name[f"rd{b}"]
        # primary read1 record: position matches truth (1-based)
        r1 = [f for f in recs if int(f[1]) & 0x40 and not int(f[1]) & 0x100][0]
        assert int(f1 := int(r1[3])) == starts[b] + 1
        assert r1[2] == "chrT"
        assert int(r1[1]) & 0x2  # proper pair
        assert r1[5] == "80M"
        assert r1[9] == decode_seq(reads1[b])
        # read2 is reverse strand: SEQ is the revcomp (= original fwd ref)
        r2 = [f for f in recs if int(f[1]) & 0x80 and not int(f[1]) & 0x100][0]
        assert int(r2[1]) & 0x10


def test_bwa_single_mapq_table():
    """bwaLikeSingleQualScore (BGS-IO.cpp:710-728) hand cases:
    g_log_n[x] = int(4.343*ln(x)+0.5)."""
    from megapath.io.sam import bwa_single_mapq

    assert bwa_single_mapq(2, 0) == 0  # multiple optimal hits
    assert bwa_single_mapq(1, 0) == 37  # unique, no suboptimal
    # x1=1: g_log_n[1]=0 -> 23; x1=2: int(4.343*ln2+.5)=3 -> 20
    assert bwa_single_mapq(1, 1) == 23
    assert bwa_single_mapq(1, 2) == 20
    # x1=255: g_log_n=int(4.343*ln255+.5)=24 > 23 -> 0
    assert bwa_single_mapq(1, 255) == 0
    assert bwa_single_mapq(1, 300) == 0  # clamped at 255


def test_bwa_pair_mapq_cases():
    """bwaLikePairQualScore (BGS-IO.cpp:814-877) hand cases."""
    from megapath.io.sam import bwa_pair_mapq

    # both ends unique/no-subopt: 37+37 capped at 60, both get it
    assert bwa_pair_mapq(1, 0, 1, 0, 160, 1, 0, 0, 80, 80) == (60, 60)
    # one end repetitive (x0>1 -> mapq0=0), unique pair, no subopt pair:
    # mapq_p=29; mapq0 = min(29+7, mapq1=37) = 36
    assert bwa_pair_mapq(2, 0, 1, 0, 160, 1, 0, 0, 80, 80) == (36, 37)
    # repetitive end + suboptimal pair with big gap (>0.3*80 after x10):
    # mapq_p=23 -> mapq0 = min(30, 37) = 30
    assert bwa_pair_mapq(2, 0, 1, 0, 160, 1, 100, 1, 80, 80) == (30, 37)
    # close subop: (1600-1580)/2 - g_log_n[1]=0 -> 10; min(17,37)=17
    assert bwa_pair_mapq(2, 0, 1, 0, 160, 1, 158, 1, 80, 80) == (17, 37)
    # multiple best pairs: op_num != 1 -> mapq_p stays 0 -> min(7, 37)
    assert bwa_pair_mapq(2, 0, 1, 0, 160, 2, 0, 0, 80, 80) == (7, 37)
