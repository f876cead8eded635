"""Index subsystem tests: packing, suffix array, FM-index vs brute force."""

import numpy as np
import pytest

from megapath.index import (
    FMIndex,
    build_fm_index,
    decode_seq,
    encode_seq,
    pack_fasta,
    revcomp,
    suffix_array,
)
from megapath.index.suffix import validate_sa
from megapath.io.fastq import FastqRecord


def _rand_codes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 4, size=n).astype(np.uint8)


def test_encode_decode():
    assert decode_seq(encode_seq("ACGT")) == "ACGT"
    np.testing.assert_array_equal(encode_seq("ACGTN"), [0, 1, 2, 3, 2])  # N->G
    np.testing.assert_array_equal(revcomp(encode_seq("ACGT")), encode_seq("ACGT"))
    assert decode_seq(revcomp(encode_seq("AACG"))) == "CGTT"


def test_pack_fasta_offsets_and_amb():
    recs = [
        FastqRecord("s1", "ACGTNNACGT", "", "desc one"),
        FastqRecord("s2", "GGGG", "", ""),
    ]
    ref = pack_fasta(recs)
    assert ref.total_len == 14
    assert ref.names == ["s1", "s2"]
    assert ref.annotations[0] == "s1 desc one"
    np.testing.assert_array_equal(ref.offsets, [0, 10, 14])
    np.testing.assert_array_equal(ref.ambiguous, [[4, 6]])
    seq_idx, local = ref.local_pos(np.array([0, 9, 10, 13]))
    np.testing.assert_array_equal(seq_idx, [0, 0, 1, 1])
    np.testing.assert_array_equal(local, [0, 9, 0, 3])


@pytest.mark.parametrize("n", [1, 2, 10, 257, 1000])
def test_suffix_array_matches_naive(n):
    codes = _rand_codes(n, seed=n)
    sa = suffix_array(codes)
    naive = sorted(range(n), key=lambda i: codes[i:].tobytes())
    np.testing.assert_array_equal(sa, naive)
    assert validate_sa(codes, sa)


def _brute_find(codes, pat):
    """All text positions where pat occurs (numpy rolling compare)."""
    n, m = len(codes), len(pat)
    if m == 0 or m > n:
        return []
    hits = []
    for i in range(n - m + 1):
        if (codes[i : i + m] == pat).all():
            hits.append(i)
    return hits


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_backward_search_matches_brute(seed):
    codes = _rand_codes(700, seed)
    fm = build_fm_index(codes, sa_interval=4, lut_k=4)
    rng = np.random.default_rng(seed + 100)
    for trial in range(25):
        m = int(rng.integers(1, 12))
        if rng.random() < 0.7:  # sample from the text so hits exist
            p0 = int(rng.integers(0, len(codes) - m))
            pat = codes[p0 : p0 + m].copy()
        else:
            pat = rng.integers(0, 4, size=m).astype(np.uint8)
        lo, hi = np.array([0]), np.array([fm.n + 1])
        for c in pat[::-1]:
            lo, hi = fm.extend_backward(lo, hi, np.array([c]))
        want = sorted(_brute_find(codes, pat))
        assert int(hi[0] - lo[0]) == len(want)
        if len(want):
            got = sorted(fm.locate(np.arange(lo[0], hi[0])).tolist())
            assert got == want


def test_backward_search_batched():
    codes = _rand_codes(500, 9)
    fm = build_fm_index(codes, sa_interval=4, lut_k=0)
    pats = np.stack([codes[i : i + 8] for i in range(0, 400, 13)])
    B = len(pats)
    lo = np.zeros(B, dtype=np.int64)
    hi = np.full(B, fm.n + 1, dtype=np.int64)
    for j in range(7, -1, -1):
        lo, hi = fm.extend_backward(lo, hi, pats[:, j])
    for b in range(B):
        want = _brute_find(codes, pats[b])
        assert int(hi[b] - lo[b]) == len(want)


def test_lut_matches_backward_search():
    codes = _rand_codes(2000, 5)
    k = 5
    fm = build_fm_index(codes, sa_interval=4, lut_k=k)
    rng = np.random.default_rng(7)
    for _ in range(40):
        pat = rng.integers(0, 4, size=k).astype(np.uint8)
        lo, hi = np.array([0]), np.array([fm.n + 1])
        for c in pat[::-1]:
            lo, hi = fm.extend_backward(lo, hi, np.array([c]))
        kmer = 0
        for c in pat:
            kmer = kmer * 4 + int(c)
        glo, ghi = fm.lut_interval(np.array([kmer]))
        assert (int(glo[0]), int(ghi[0])) == (int(lo[0]), int(hi[0])) or (
            ghi[0] <= glo[0] and hi[0] <= lo[0]
        )


def test_lut_short_suffix_exclusion():
    # text ending in AAAA: k-mer AAAA bucket must exclude short suffixes
    codes = encode_seq("CGTACGAAAA")
    fm = build_fm_index(codes, sa_interval=1, lut_k=4)
    kmer = 0  # AAAA
    lo, hi = fm.lut_interval(np.array([kmer]))
    pat = encode_seq("AAAA")
    assert int(hi[0] - lo[0]) == len(_brute_find(codes, pat)) == 1


def test_locate_full_vs_sampled():
    codes = _rand_codes(300, 11)
    fm1 = build_fm_index(codes, sa_interval=1, lut_k=0)
    fm8 = build_fm_index(codes, sa_interval=8, lut_k=0)
    rows = np.arange(1, fm1.n + 1)
    np.testing.assert_array_equal(fm1.locate(rows), fm8.locate(rows))


def test_save_load_roundtrip(tmp_path):
    codes = _rand_codes(400, 13)
    fm = build_fm_index(codes, sa_interval=4, lut_k=4)
    p = str(tmp_path / "fm.npz")
    fm.save(p)
    fm2 = FMIndex.load(p)
    rows = np.arange(1, fm.n + 1, 7)
    np.testing.assert_array_equal(fm.locate(rows), fm2.locate(rows))
    assert fm2.lut_k == 4


def test_split_ref_to_reads():
    from megapath.index.dbtools import split_ref_to_reads
    from megapath.io.fastq import FastqRecord

    recs = [FastqRecord("ctg", "ACGTACGTAC", "", "")]
    out = list(split_ref_to_reads(recs, read_len=4, overlap=3))
    assert [r.name for r in out] == ["ctg_0", "ctg_3", "ctg_6"]
    assert [r.seq for r in out] == ["ACGT", "TACG", "GTAC"]
    # final window flush when not aligned
    out = list(split_ref_to_reads(recs, read_len=7, overlap=5))
    assert [r.seq for r in out] == ["ACGTACG", "CGTACGT"][:len(out)] or out


def test_revcomp_fastx():
    from megapath.index.dbtools import revcomp_fastx
    from megapath.io.fastq import FastqRecord

    out = list(revcomp_fastx([FastqRecord("r", "ACGTN", "IJKLM", "")]))
    assert out[0].seq == "NACGT"
    assert out[0].qual == "MLKJI"


def test_smart_pairing():
    from megapath.index.dbtools import smart_pairing
    from megapath.io.fastq import FastqRecord

    recs = [
        FastqRecord("a/1", "AC", "II", ""),
        FastqRecord("a/2", "GT", "II", ""),
        FastqRecord("b/1", "CC", "II", ""),
        FastqRecord("c/1", "GG", "II", ""),
        FastqRecord("c/2", "TT", "II", ""),
    ]
    pairs, singles = smart_pairing(recs)
    assert [r.name for r in pairs] == ["a", "a", "c", "c"]
    assert [r.name for r in singles] == ["b"]


def test_split_fasta_shard_cap(tmp_path):
    """Splitter packs sequences up to max_bp per shard; an oversized
    sequence gets its own shard (splitFasta.pl semantics, with the
    int32-safe 2 Gbp default pinned in index/shard.py)."""
    from megapath.index.shard import DEFAULT_SHARD_BP, split_fasta
    from megapath.io.fastq import read_fastx

    assert DEFAULT_SHARD_BP == int(2.0e9)  # pinned design decision
    p = tmp_path / "ref.fa"
    seqs = [("a", "A" * 50), ("b", "C" * 40), ("c", "G" * 70),
            ("d", "T" * 150), ("e", "A" * 10)]
    with open(p, "w") as f:
        for n, s in seqs:
            f.write(f">{n}\n{s}\n")
    shards = split_fasta(p, str(tmp_path / "out"), max_bp=100)
    got = [[(r.name, len(r.seq)) for r in read_fastx(sp)] for sp in shards]
    # a+b fit in 100; c starts a new shard; d oversized -> own shard
    assert got == [
        [("a", 50), ("b", 40)],
        [("c", 70)],
        [("d", 150)],
        [("e", 10)],
    ]


def test_device_fm_rejects_oversized_shard():
    """>2^31 shard must fail loudly at device-index construction."""
    from types import SimpleNamespace

    import pytest as _pytest

    from megapath.align.seeding_jax import DeviceFM

    with _pytest.raises(AssertionError, match="2\\^31|2\\*\\*31|shard"):
        DeviceFM.from_host(SimpleNamespace(n=2**31))


def test_db_construction_tools(mini_taxdb):
    """createDB / filterDB / selectSameSpecieGenome / surpiAnn2id
    (cc/createDB.cpp, filterDB.cpp, selectSameSpecieGenome.cc,
    surpiAnn2id.cpp)."""
    from megapath.index.dbtools import (
        create_db,
        filter_db,
        header2acc,
        select_same_species_genome,
        surpi_ann2id,
    )
    from megapath.io.fastq import FastqRecord

    # header parsing: old gi|, new multi-acc with \x01, UniVec
    assert header2acc("gi|123|ref|NC_000913.3| E coli") == ["NC_000913"]
    assert header2acc("NC_000913.3 first\x01NC_003197.2 second") == [
        "NC_000913", "NC_003197",
    ]
    assert header2acc("gnl|uv|U12345.1:1-100") == ["U12345"]

    nt = [
        FastqRecord("NC_000913.3", "ACGTACGT", "", "E coli genome"),
        FastqRecord("UNKNOWN.1", "ACGTACGT", "", "no taxid"),
    ]
    uv = [FastqRecord("gnl|uv|U12345.1:1-10", "GGGG", "", "")]
    hg = [FastqRecord("NC_000001.11", "TTTT", "", "")]
    out = list(create_db(nt, uv, hg, mini_taxdb))
    assert [r.name for r in out] == ["NC_000913", "U12345", "NC_000001"]

    # filterDB: drop anything under a named taxon
    recs = [
        FastqRecord("NC_000913.3", "ACGT", "", ""),
        FastqRecord("NC_045512.2", "ACGT", "", ""),
    ]
    name913 = mini_taxdb.name_of(
        mini_taxdb.pop_to_species(mini_taxdb.acc2tid["NC_000913"])
    )
    kept = list(filter_db(recs, mini_taxdb, [name913]))
    assert [r.name for r in kept] == ["NC_045512.2"]

    # selectSameSpecieGenome: one 'complete genome' per species
    tid913 = mini_taxdb.acc2tid["NC_000913"]
    recs = [
        FastqRecord("NC_000913.3", "AAAA", "", "strain 1, complete genome"),
        FastqRecord("NC_000913.2", "CCCC", "", "strain 2, complete genome"),
        FastqRecord("NC_000913.1", "GGGG", "", "partial cds"),
    ]
    sel = select_same_species_genome(recs, mini_taxdb, [tid913])
    assert len(sel) == 1
    assert "complete genome" in sel[0].comment

    # surpiAnn2id: species--Name -> taxid
    import pathlib

    names = pathlib.Path(__file__).parent / "fixtures" / "names.dmp"
    name = mini_taxdb.name_of(mini_taxdb.pop_to_species(tid913))
    lines = [f"ACC1#junk\tfoo\tspecies--{name}\tbar"]
    out = list(surpi_ann2id(names, lines))
    sp = mini_taxdb.pop_to_species(tid913)
    assert out == [f"ACC1\t{sp}"]


def test_kraken_censtruct_and_extract_region():
    from megapath.index.dbtools import extract_region, kraken_censtruct
    from megapath.index.pack import pack_fasta
    from megapath.io.fastq import FastqRecord

    recs = [FastqRecord("seqA", "ACGTACGTAC", "", ""),
            FastqRecord("seqB", "GGGGCCCC", "", "")]
    out = list(kraken_censtruct(recs, seqid2taxid={"seqA": 7}))
    assert [r.name for r in out] == ["seqA|kraken:taxid|7"]  # seqB dropped
    out = list(kraken_censtruct(recs, taxid=99))
    assert [r.name for r in out] == [
        "seqA|kraken:taxid|99", "seqB|kraken:taxid|99",
    ]

    ref = pack_fasta(recs)
    assert extract_region(ref, "seqB", 2, 6) == "GGCC"
    assert extract_region(ref, "seqA", 8, 99) == "AC"  # clamped
