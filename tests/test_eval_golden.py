"""Evaluation-tool byte parity vs the reference binaries.

Goldens in tests/fixtures/eval_* were produced by the compiled
reference cc tools (make_eval_fixtures.py): calculate_m8_cov,
m8_to_mapLen_hist (with and without the ref/contig FASTAs), and
genCountTable."""

import pathlib

FIX = pathlib.Path(__file__).parent / "fixtures"


def test_m8_coverage_byte_parity():
    from megapath.utils.accuracy import m8_coverage

    got = m8_coverage(open(FIX / "eval_in.m8"))
    assert got == (FIX / "eval_cov.golden").read_text()


def test_maplen_hist_byte_parity():
    from megapath.utils.accuracy import maplen_stats

    got = maplen_stats(
        open(FIX / "eval_in.m8"),
        ref_fa=FIX / "eval_ref.fa",
        contig_fa=FIX / "eval_q.fa",
    )
    assert got == (FIX / "eval_hist.golden").read_text()


def test_maplen_hist_no_fasta_byte_parity():
    from megapath.utils.accuracy import maplen_stats

    got = maplen_stats(open(FIX / "eval_in.m8"))
    assert got == (FIX / "eval_hist_nofa.golden").read_text()


def test_count_table_byte_parity():
    from megapath.io.lsam import read_lsam
    from megapath.taxonomy.taxdb import TaxDB
    from megapath.utils.accuracy import count_table

    db = TaxDB(size=3_000_000)
    db.read_nodes(FIX / "nodes.dmp")
    db.read_names(FIX / "names.dmp")
    recs = [r for r in read_lsam(FIX / "golden.lsam.id") if r.score >= 40]
    got = count_table(db, recs)
    assert got == (FIX / "eval_counttable.golden").read_text()
