"""Tests: streaming reader, bbnorm, protein-path tools, accuracy, CLI."""

import numpy as np

from megapath.classify.extras import cleanup_contaminants, m8_to_lsam, r2c_to_r2g
from megapath.filters.bbnorm import normalize_pairs
from megapath.io.lsam import LsamRecord
from megapath.io.stream import stream_read_pairs
from megapath.utils.accuracy import evaluate


def test_stream_read_pairs(tmp_path):
    r1 = tmp_path / "a_1.fq"
    r2 = tmp_path / "a_2.fq"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for i in range(25):
            f1.write(f"@r{i}/1\nACGTACGT\n+\nIIIIIIII\n")
            f2.write(f"@r{i}/2\nTTGGCCAA\n+\nIIIIIIII\n")
    batches = list(stream_read_pairs(r1, r2, batch_size=10, max_len=16))
    assert [len(b) for b in batches] == [10, 10, 5]
    assert batches[0].names[0] == "r0"
    assert batches[0].reads1.shape == (10, 16)
    assert batches[2].lens2.tolist() == [8] * 5


def test_bbnorm_downsamples_deep_coverage():
    rng = np.random.default_rng(0)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 500))
    # 200 identical-region pairs (deep) + 20 unique pairs
    deep1 = [seq[0:100]] * 200
    deep2 = [seq[100:200]] * 200
    uniq1 = ["".join("ACGT"[i] for i in rng.integers(0, 4, 100)) for _ in range(20)]
    uniq2 = ["".join("ACGT"[i] for i in rng.integers(0, 4, 100)) for _ in range(20)]
    keep = normalize_pairs(deep1 + uniq1, deep2 + uniq2, target=20)
    assert keep[200:].all()  # unique reads all kept
    kept_deep = keep[:200].sum()
    assert 15 <= kept_deep <= 120  # deep region cut to well below 200


def test_m8_to_lsam():
    lines = [
        "read1\t562\t99.0\t100\t1\t0\t1\t100\t5\t104\t1e-30\t180.5",
        "read1\t289010x1562\t98.0\t100\t2\t0\t1\t100\t5\t104\t1e-28\t170",
        "read2\t9606\t90\t80\t8\t0\t1\t80\t3\t82\t1e-10\t95.2",
    ]
    recs = list(m8_to_lsam(lines))
    assert len(recs) == 2
    assert recs[0].name == "read1"
    assert recs[0].score == 180
    assert (170.0, "28901") in recs[0].hits
    assert (170.0, "562") in recs[0].hits


def test_r2c_to_r2g():
    # byte-verified vs /root/reference/r2c_to_r2g.pl: the read inherits
    # the contig's raw hit labels (contig-side scores kept) for its
    # contig hits whose read-side score passes the threshold
    r2c = [LsamRecord("read1", 0, 90, hits=[(90.0, "1")])]
    c2g = [LsamRecord("contig_1", 0, 500, hits=[(500.0, "NC_1"), (450.0, "NC_2")])]
    out = list(r2c_to_r2g(iter(r2c), iter(c2g)))
    assert out[0].hits == [(500.0, "NC_1"), (450.0, "NC_2")]
    assert out[0].seq == "*" and out[0].qual == "*"


def test_r2c_to_r2g_unaligned_contig():
    # an unaligned contig (hits '*') must not crash the join and must
    # contribute no genome hits (r2c_to_r2g.pl stores the raw label)
    r2c = [LsamRecord("read1", 0, 90, hits=[(90.0, "1"), (85.0, "2")])]
    c2g = [
        LsamRecord("contig_1", 0, 0, hits=[]),  # '*' label
        LsamRecord("contig_2", 0, 500, hits=[(500.0, "NC_9")]),
    ]
    out = list(r2c_to_r2g(iter(r2c), iter(c2g)))
    assert out[0].hits == [(500.0, "NC_9")]


def test_cleanup_contaminants():
    # species 562 always co-occurs with human at similar score -> removed
    recs = []
    for i in range(10):
        recs.append(LsamRecord(f"r{i}", 0, 150, hits=[(100.0, "562"), (98.0, "9606")]))
    for i in range(10):
        recs.append(LsamRecord(f"s{i}", 0, 150, hits=[(100.0, "28901")]))
    out, removed = cleanup_contaminants(recs, fraction=0.5)
    assert removed == {562}
    assert all("562" not in [t for _, t in r.hits] for r in out)
    assert any("28901" in [t for _, t in r.hits] for r in out)


def test_accuracy_eval(mini_taxdb):
    recs = [
        LsamRecord("read_ecoli_1", 0, 150, hits=[(150.0, "562")]),
        LsamRecord("read_ecoli_2", 0, 150, hits=[(150.0, "28901")]),  # wrong
        LsamRecord("read_salm_1", 0, 20, hits=[(20.0, "28901")]),  # low score
    ]
    truth = {"read_ecoli_1": 562, "read_ecoli_2": 562, "read_salm_1": 28901}
    st = evaluate(recs, truth.get, mini_taxdb)
    assert st.tp == 1
    assert st.fn == 2
    assert st.fp == 1
    assert 0 < st.sensitivity < 1


def test_cli_report(tmp_path, fixtures_dir, capsys):
    from megapath.cli import main

    rc = main([
        "report",
        str(fixtures_dir / "nodes.dmp"),
        str(fixtures_dir / "names.dmp"),
        str(fixtures_dir / "golden.lsam.id"),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    golden = (fixtures_dir / "golden.report").read_text()
    assert out == golden


def test_sam2cfq_scores_and_hits():
    from megapath.io.sam2cfq import sam_to_cfq, score_from_cigar_nm

    # 100M with NM=2 -> 98 matches*1 + 2 mism*-2 = 94
    assert score_from_cigar_nm("100M", 2) == 94
    # 50M2D50M NM=2 (the deletion): gap open -3, extend -1
    assert score_from_cigar_nm("50M2D50M", 2) == 100 - 3 - 1
    lines = [
        "@SQ\tSN:x\tLN:1",
        "r1\t0\tNC_1.1\t10\t60\t100M\t*\t0\t0\t" + "A" * 100 + "\t" + "I" * 100 + "\tNM:i:0\tAS:i:100",
        "r2\t4\t*\t0\t0\t*\t*\t0\t0\tAAAA\tIIII",
        "r3\t16\tkraken:taxid|562|seq\t5\t60\t4M\t*\t0\t0\tACGT\tIIII\tNM:i:0",
    ]
    recs = list(sam_to_cfq(lines))
    assert recs[0].comment == "SCORE:100;100,NC_1.1;"
    assert recs[1].comment == "SCORE:0;"
    assert recs[2].comment == "SCORE:4;4,562;"
    assert recs[2].seq == "ACGT"[::-1].translate(str.maketrans("ACGT", "TGCA"))


def test_stage_timer():
    import io as _io

    from megapath.utils.timing import StageTimer

    buf = _io.StringIO()
    t = StageTimer(out=buf)
    with t.stage("x"):
        pass
    assert "TIMER" in buf.getvalue()
    assert "x" in t.summary()


def test_japsa_to_kraken_report(tmp_path):
    from megapath.classify.extras import japsa_to_kraken_report
    from megapath.taxonomy.taxdb import TaxDB
    import pathlib

    fx = pathlib.Path(__file__).parent / "fixtures"
    db = TaxDB(size=4096)
    db.read_nodes(fx / "nodes.dmp")
    db.read_names(fx / "names.dmp")
    # pick two known species tids from the mini taxonomy
    sp = [t for t in range(len(db.parent)) if db.rank_of(t) == "species"][:2]
    assert len(sp) == 2
    lines = [
        "header\tcols",
        f"x\tx\tx\tx\t{sp[0]}\tx\tx\tx\t70",
        f"x\tx\tx\tx\t{sp[1]}\tx\tx\tx\t30",
    ]
    rpt = japsa_to_kraken_report(db, lines)
    rows = rpt.splitlines()
    assert rows[0].startswith("prec\t")
    assert any(f"\t{sp[0]}\t" in r and "70.00" in r for r in rows)
    assert any(f"\t{sp[1]}\t" in r and "30.00" in r for r in rows)
    # clade counts roll up: root row carries 100%
    root = [r for r in rows if "\t1\t0\t" in r]
    assert root and root[0].startswith("100.00\t100\t")


def test_filter_cross_family_reads():
    import pathlib

    from megapath.classify.extras import filter_cross_family_reads
    from megapath.taxonomy.taxdb import TaxDB

    fx = pathlib.Path(__file__).parent / "fixtures"
    db = TaxDB(size=3_000_000)
    db.read_nodes(fx / "nodes.dmp")
    db.read_names(fx / "names.dmp")
    db.read_acc2tid(fx / "acc2tid.map")
    accs = sorted(db.acc2tid)
    # two accessions in the same family vs two in different families
    fam_of = {}
    for a in accs:
        t = db.acc2tid[a]
        while t not in (0, 1) and db.rank_of(t) != "family":
            t = int(db.parent[t])
        fam_of[a] = t
    same = [a for a in accs if fam_of[a] == fam_of[accs[0]]][:2]
    other = next(a for a in accs if fam_of[a] != fam_of[accs[0]])
    recs = [
        LsamRecord("keep", 64, 100, "ACGT", "IIII",
                   [(100.0, same[0]), (90.0, same[-1])]),
        LsamRecord("drop", 64, 100, "TTTT", "IIII",
                   [(100.0, same[0]), (90.0, other)]),
        LsamRecord("star", 64, 0, "GGGG", "IIII", []),
    ]
    out = list(filter_cross_family_reads(db, recs))
    names = [r.name for r in out]
    assert "keep" in names and "star" in names and "drop" not in names
