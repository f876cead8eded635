"""Byte-parity tests: cfq -> LSAM -> LSAM.id -> reassign -> Kraken report.

Golden outputs in tests/fixtures were produced by the *reference* MegaPath
cc tools (see make_fixtures.py); our host-side reimplementations must
match them byte for byte.
"""

import io

from megapath.io import fastq as fq
from megapath.io import lsam as lsam_mod
from megapath.classify.taxlookup import tax_lookup_acc
from megapath.classify.reassign import reassign_lines
from megapath.taxonomy.report import gen_kraken_report


def test_fastq_roundtrip(tmp_path):
    recs = [
        fq.FastqRecord("r1", "ACGT", "IIII", "SCORE:10;10,X;"),
        fq.FastqRecord("r2", "GGTA", "FFFF", ""),
    ]
    p = tmp_path / "t.fq"
    fq.write_fastq(recs, p)
    back = list(fq.read_fastx(p))
    assert [(r.name, r.seq, r.qual, r.comment) for r in back] == [
        (r.name, r.seq, r.qual, r.comment) for r in recs
    ]


def test_fasta_multiline(tmp_path):
    p = tmp_path / "t.fa"
    p.write_text(">chr1 desc\nACGT\nTTTT\n>chr2\nGG\n")
    recs = list(fq.read_fastx(p))
    assert recs[0].name == "chr1"
    assert recs[0].comment == "desc"
    assert recs[0].seq == "ACGTTTTT"
    assert recs[1].seq == "GG"


def test_cfq_hits_parsing():
    r = fq.FastqRecord("r", "A", "I", "SCORE:120;120,accA,accB;114,accC;")
    assert r.score == 120
    assert r.hits() == [(120, "accA"), (120, "accB"), (114, "accC")]
    r2 = fq.FastqRecord("r", "A", "I", "IGNORE")
    assert r2.score == -1


def test_fastq2lsam_golden(fixtures_dir):
    buf = io.StringIO()
    lsam_mod.fastq_to_lsam(fq.read_fastx(fixtures_dir / "mini.cfq"), buf, output_seq=True)
    golden = (fixtures_dir / "golden.lsam").read_text()
    assert buf.getvalue() == golden


def test_lsam_parse_roundtrip(fixtures_dir):
    for line in (fixtures_dir / "golden.lsam").read_text().splitlines():
        rec = lsam_mod.parse_lsam_line(line)
        assert rec.to_line() == line


def test_taxlookup_golden(fixtures_dir, mini_taxdb):
    lines = (fixtures_dir / "golden.lsam").read_text().splitlines()
    out = "\n".join(tax_lookup_acc(mini_taxdb, lines)) + "\n"
    golden = (fixtures_dir / "golden.lsam.id").read_text()
    assert out == golden


def test_reassign_golden(fixtures_dir):
    lines = (fixtures_dir / "golden.lsam.id").read_text().splitlines()
    out = "\n".join(reassign_lines(lines, t=40)) + "\n"
    golden = (fixtures_dir / "golden.ra.lsam.id").read_text()
    assert out == golden


def test_kraken_report_golden(fixtures_dir, mini_taxdb):
    lines = (fixtures_dir / "golden.lsam.id").read_text().splitlines()
    out = gen_kraken_report(mini_taxdb, lines, score_threshold=40)
    golden = (fixtures_dir / "golden.report").read_text()
    assert out == golden


def test_kraken_report_after_reassign_golden(fixtures_dir, mini_taxdb):
    lines = (fixtures_dir / "golden.ra.lsam.id").read_text().splitlines()
    out = gen_kraken_report(mini_taxdb, lines, score_threshold=40)
    golden = (fixtures_dir / "golden.ra.report").read_text()
    assert out == golden


def test_deinterleave(tmp_path, fixtures_dir):
    recs = fq.read_fastx(fixtures_dir / "mini.cfq")
    p1, p2, se = lsam_mod.deinterleave(recs, str(tmp_path / "x"))
    pe1 = list(fq.read_fastx(p1))
    pe2 = list(fq.read_fastx(p2))
    single = list(fq.read_fastx(se))
    assert len(pe1) == len(pe2) == 8
    assert len(single) == 1
    assert single[0].name == "read_single_1/0".replace("/0", "")
    assert pe1[0].name.endswith("/1") and pe2[0].name.endswith("/2")


def test_lsam_read_filter():
    lines = ["bad\t0\t10\t*\t*\t*", "good\t0\t10\t*\t*\t*"]
    kept = list(lsam_mod.lsam_read_filter(["bad/1"], lines))
    assert kept == ["good\t0\t10\t*\t*\t*"]
