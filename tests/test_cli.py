"""CLI stream-tool subcommands (the cc/ toolchain surface).

Each reference tool is a separate binary on a pipe
(/root/reference/cc/Makefile); here they are subcommands of one
console script. These tests drive main() directly with tmp files.
"""

import io
import sys

import pytest

from megapath.cli import main


def run_cli(argv, stdin_text=None, capsys=None, monkeypatch=None):
    if stdin_text is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


def test_fastq2lsam(tmp_path, capsys, monkeypatch):
    p = tmp_path / "a.cfq"
    p.write_text(
        "@r1\tSCORE:50;50,acc1\nACGT\n+\nIIII\n"
        "@r1\tSCORE:45;45,acc1\nTTAA\n+\nIIII\n"
    )
    rc, out = run_cli(["fastq2lsam", str(p)], capsys=capsys)
    assert rc == 0
    lines = out.strip().split("\n")
    assert lines[0] == "r1\t64\t50\tACGT\tIIII\t50,acc1"
    assert lines[1].startswith("r1\t128\t45")


def test_extract_pairs(tmp_path, capsys, monkeypatch):
    p = tmp_path / "a.lsam"
    p.write_text(
        "r1\t64\t50\tACGT\tIIII\t50,acc1\n"
        "r1\t128\t10\tTTAA\tIIII\t*\n"
        "r2\t64\t90\tACGT\tIIII\t90,acc1\n"
        "r2\t128\t95\tTTAA\tIIII\t95,acc1\n"
    )
    rc, out = run_cli(["extract", "-t", "40", str(p)], capsys=capsys)
    assert rc == 0
    # r1 selected (end 2 under cutoff), r2 fully mapped -> dropped
    assert "@r1/1" in out and "@r1/2" in out and "r2" not in out


def test_extract_fractional_threshold(tmp_path, capsys, monkeypatch):
    p = tmp_path / "a.lsam"
    # pair len 8 -> cut = 0.9*8 = 7.2; scores 7 < 7.2 selects
    p.write_text(
        "r1\t64\t7\tACGT\tIIII\t7,acc1\nr1\t128\t9\tTTAA\tIIII\t9,acc1\n"
    )
    rc, out = run_cli(["extract", "-t", "0.9", str(p)], capsys=capsys)
    assert "@r1/1" in out


def test_m8_to_lsam(tmp_path, capsys, monkeypatch):
    p = tmp_path / "a.m8"
    p.write_text(
        "q1\ts10x1s2\t99\t100\t0\t0\t1\t100\t5\t105\t1e-30\t200\n"
    )
    rc, out = run_cli(["m8-to-lsam", str(p)], capsys=capsys)
    assert out.strip() == "q1\t0\t200\t*\t*\t200,s1;200,s2"


def test_genomecov_filter(tmp_path, capsys, monkeypatch):
    g = tmp_path / "g.genome"
    g.write_text("chr1\t100\n")
    c = tmp_path / "cov.bed"
    c.write_text("chr1\t0\t50\t2\nchr1\t50\t60\t500\nchr1\t60\t100\t2\n")
    rc, out = run_cli(
        ["genomecov-filter", str(g), str(c), "2"], capsys=capsys
    )
    assert out.strip() == "chr1\t50\t60"


def test_lsam_read_filter(tmp_path, capsys, monkeypatch):
    ban = tmp_path / "ban.txt"
    ban.write_text("r1\n")
    p = tmp_path / "a.lsam"
    p.write_text("r1\t64\t50\t*\t*\t*\nr2\t64\t50\t*\t*\t*\n")
    rc, out = run_cli(["lsam-read-filter", str(ban), str(p)], capsys=capsys)
    assert out.strip() == "r2\t64\t50\t*\t*\t*"


def test_r2c_to_r2g(tmp_path, capsys, monkeypatch):
    # byte-verified against /root/reference/r2c_to_r2g.pl: contig names
    # must match ^contig_(id); the read inherits the contig's raw hit
    # labels when its read->contig score passes the threshold
    r2c = tmp_path / "r2c.lsam"
    r2c.write_text("read1\t64\t30\t*\t*\t50,12;25,13\n")
    c2g = tmp_path / "c2g.lsam"
    c2g.write_text(
        "contig_12\t0\t99\t*\t*\t99,9606;80,562\n"
        "contig_13\t0\t70\t*\t*\t70,562\n"
    )
    rc, out = run_cli(["r2c-to-r2g", str(r2c), str(c2g)], capsys=capsys)
    assert out.strip() == "read1\t64\t30\t*\t*\t99,9606;80,562"


def test_sam2cfq(tmp_path, capsys, monkeypatch):
    p = tmp_path / "a.sam"
    p.write_text(
        "@SQ\tSN:chr1\tLN:1000\n"
        "r9\t0\tchr1\t10\t60\t4M\t*\t0\t0\tACGT\tIIII\tAS:i:4\tNM:i:0\n"
    )
    rc, out = run_cli(["sam2cfq", str(p)], capsys=capsys)
    assert out.startswith("@r9 SCORE:4;4,chr1")


def test_deinterleave(tmp_path, capsys, monkeypatch):
    p = tmp_path / "a.cfq"
    p.write_text(
        "@r1\tc1\nACGT\n+\nIIII\n@r1\tc2\nTTAA\n+\nIIII\n"
        "@solo\nGGGG\n+\nIIII\n"
    )
    rc, _ = run_cli(
        ["deinterleave", str(tmp_path / "out"), str(p)], capsys=capsys
    )
    assert (tmp_path / "out.pe_1.fq").read_text().startswith("@r1/1")
    assert "@solo" in (tmp_path / "out.se.fq").read_text()


def test_reassign_cli(tmp_path, capsys, monkeypatch):
    p = tmp_path / "a.lsamid"
    p.write_text(
        "r1\t64\t50\t*\t*\t50,101;45,102\nr1\t128\t45\t*\t*\t45,101\n"
    )
    rc, out = run_cli(["reassign", str(p)], capsys=capsys)
    assert rc == 0 and "101" in out


def test_m8_cov(tmp_path, capsys, monkeypatch):
    p = tmp_path / "a.m8"
    p.write_text(
        "q1\ts1\t99\t50\t0\t0\t1\t50\t10\t59\t1e-9\t90\n"
        "q2\ts1\t99\t50\t0\t0\t1\t50\t40\t99\t1e-9\t90\n"
        "q3\ts1\t99\t20\t0\t0\t1\t20\t200\t181\t1e-9\t40\n"
    )
    rc, out = run_cli(["m8-cov", str(p)], capsys=capsys)
    # [10,59]+[40,99] merge to [10,99] (90), [181,200] reversed (20);
    # byte format matches the reference binary (test_eval_golden)
    assert out.splitlines()[0] == "s1\t10,99;181,200;\t110"


def test_maplen_hist(tmp_path, capsys, monkeypatch):
    p = tmp_path / "a.m8"
    p.write_text(
        "q1\ts1\t99\t50\t0\t0\t1\t50\t10\t59\t1e-9\t90\n"
        "q1\ts1\t99\t30\t0\t0\t1\t30\t80\t109\t1e-9\t50\n"  # dup query: skipped
        "q2\ts1\t99\t30\t0\t0\t1\t30\t70\t99\t1e-9\t50\n"
    )
    rc, out = run_cli(["maplen-hist", str(p)], capsys=capsys)
    # first-hit-per-query only (dup q1 row skipped) => 2 rows + summary
    assert "Target: s1" in out
    assert "NC50" in out
    body = [l for l in out.splitlines() if "\t" in l and "Target" not in l]
    assert len(body) == 3  # 2 per-hit rows + the summary line


def test_count_table(tmp_path, capsys, monkeypatch, fixtures_dir=None):
    import pathlib

    fx = pathlib.Path(__file__).parent / "fixtures"
    p = tmp_path / "a.lsamid"
    p.write_text(
        "r1\t64\t50\t*\t*\t50,562\n"          # unique E. coli
        "r2\t64\t50\t*\t*\t50,562;48,28901\n"  # two species, same family
    )
    rc, out = run_cli(
        ["count-table", str(fx / "nodes.dmp"), str(fx / "names.dmp"), str(p)],
        capsys=capsys,
    )
    rows = {l.split("\t")[0]: l.split("\t") for l in out.strip().split("\n")}
    # species 562: 1 unique (r1), 1 non-unique (r2)
    sp_rows = [l for l in out.strip().split("\n") if l.startswith("species")]
    assert any(r.split("\t")[-2:] == ["1", "1"] for r in sp_rows)
    # family level: both reads resolve to one family -> 2 unique
    fam = [l for l in out.strip().split("\n") if l.startswith("family")]
    assert fam and fam[0].split("\t")[-2:] == ["2", "0"]


def test_vcf_writer(tmp_path):
    import io as _io

    from megapath.io.vcf import write_vcf
    from megapath.pipeline.amplicon import Variant

    buf = _io.StringIO()
    vs = [Variant(seq="chr1 desc", pos=9, ref="A", alt="T", depth=20, alt_count=19)]
    write_vcf(vs, buf, contigs=[("chr1", 1000)])
    text = buf.getvalue()
    assert "##fileformat=VCFv4.2" in text
    assert "chr1\t10\t.\tA\tT\t95\tPASS\tDP=20;AC=19\tGT:AD\t1/1:1,19" in text


def test_build_db_end_to_end(tmp_path, capsys, monkeypatch):
    """One-command raw-NT -> curated sharded indexes: createDB
    curation drops artificial/unmapped sequences, filterDB
    drops the named taxon, shards get real loadable indexes."""
    import numpy as np

    rng = np.random.default_rng(3)

    def seq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    nt = tmp_path / "nt.fa"
    nt.write_text(
        f">AC001.1 Escherichia-like thing\n{seq(4000)}\n"
        f">AC002.1 synthetic construct vector\n{seq(3000)}\n"  # artificial
        f">AC003.1 Dropme species genome\n{seq(3500)}\n"  # excluded taxon
        f">AC999.1 unmapped accession\n{seq(2000)}\n"  # no acc2tid row
    )
    uv = tmp_path / "uv.fa"
    uv.write_text(f">UV001.1 UniVec segment\n{seq(1500)}\n")
    nodes = tmp_path / "nodes.dmp"
    nodes.write_text(
        "1\t|\t1\t|\tno rank\t|\t\n"
        "2\t|\t1\t|\tsuperkingdom\t|\t\n"
        "100\t|\t2\t|\tspecies\t|\t\n"
        "200\t|\t28384\t|\tspecies\t|\t\n"
        "28384\t|\t1\t|\tno rank\t|\t\n"  # 'artificial sequences' root
        "300\t|\t2\t|\tspecies\t|\t\n"
    )
    names = tmp_path / "names.dmp"
    names.write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n"
        "2\t|\tBacteria\t|\t\t|\tscientific name\t|\n"
        "100\t|\tEscherichia thing\t|\t\t|\tscientific name\t|\n"
        "200\t|\tsynthetic construct\t|\t\t|\tscientific name\t|\n"
        "28384\t|\tartificial sequences\t|\t\t|\tscientific name\t|\n"
        "300\t|\tDropme species\t|\t\t|\tscientific name\t|\n"
    )
    acc = tmp_path / "acc2tid.map"
    acc.write_text(
        "accession\taccession.version\ttaxid\tgi\n"
        "AC001\tAC001.1\t100\t0\n"
        "AC002\tAC002.1\t200\t0\n"
        "AC003\tAC003.1\t300\t0\n"
        "UV001\tUV001.1\t100\t0\n"
    )
    out_prefix = str(tmp_path / "db" / "nt")
    (tmp_path / "db").mkdir()
    rc, out = run_cli(
        [
            "build-db", "--nt", str(nt), "--univec", str(uv),
            "--nodes", str(nodes), "--names", str(names),
            "--acc2tid", str(acc), "--exclude-taxa", "Dropme species",
            "--out-prefix", out_prefix, "--shard-bp", "5000",
            "--sa-interval", "4", "--lut-k", "6",
        ],
        capsys=capsys,
    )
    assert rc == 0
    curated = (tmp_path / "db" / "nt.curated.fa").read_text()
    assert "AC001" in curated
    assert "AC002" not in curated  # artificial sequences
    assert "AC003" not in curated  # excluded taxon
    assert "AC999" not in curated  # no taxonomy mapping
    assert "UV001" in curated  # UniVec appended
    pairs = [l.split("\t") for l in out.strip().splitlines() if "\t" in l]
    assert len(pairs) >= 2  # 5.5 kbp curated at 5 kbp/shard -> 2 shards
    from megapath.index.fm import FMIndex
    from megapath.index.pack import PackedReference

    for rp, fp in pairs:
        ref = PackedReference.load(rp)
        fm = FMIndex.load(fp)
        assert fm.n == len(ref.codes)
