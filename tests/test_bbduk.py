"""bbduk-equivalent filter tests: kmask, quality trim, entropy."""

import numpy as np

from megapath.filters.bbduk import (
    KmerRef,
    average_entropy,
    bbduk_pair,
    build_kmer_ref,
    kmask,
    quality_trim,
    phred_error,
)
from megapath.index.pack import encode_seq
from megapath.io.fastq import FastqRecord


def _pack(seqs, L=128):
    codes = np.zeros((len(seqs), L), dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        c = encode_seq(s)
        codes[i, : len(c)] = c
        lens[i] = len(c)
    return codes, lens


def test_kmask_marks_adapter():
    rng = np.random.default_rng(0)
    adapter = "".join(rng.choice(list("ACGT")) for _ in range(30))
    ref = build_kmer_ref([adapter], k=27, hdist=0, mask_middle=False)
    bg = "".join(rng.choice(list("ACGT")) for _ in range(40))
    read = bg + adapter + bg[:20]
    codes, lens = _pack([read])
    is_n = np.zeros_like(codes, dtype=bool)
    m = kmask(codes, lens, is_n, ref)
    # the adapter's 27-mers span [40, 70); expect them all masked
    assert m[0, 40:70].all()
    assert not m[0, :35].any()


def test_kmask_hdist1_catches_mutant():
    rng = np.random.default_rng(1)
    adapter = "".join(rng.choice(list("ACGT")) for _ in range(27))
    ref = build_kmer_ref([adapter], k=27, hdist=1, mask_middle=False)
    mut = list(adapter)
    mut[13] = {"A": "C", "C": "G", "G": "T", "T": "A"}[mut[13]]
    read = "ACGT" * 5 + "".join(mut) + "TGCA" * 5
    codes, lens = _pack([read])
    m = kmask(codes, lens, np.zeros_like(codes, dtype=bool), ref)
    assert m[0, 20:47].all()


def test_kmask_revcomp():
    rng = np.random.default_rng(2)
    adapter = "".join(rng.choice(list("ACGT")) for _ in range(27))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = "".join(comp[c] for c in reversed(adapter))
    ref = build_kmer_ref([adapter], k=27, hdist=0, rcomp=True, mask_middle=False)
    read = "AAAA" + rc + "TTTT"
    codes, lens = _pack([read])
    m = kmask(codes, lens, np.zeros_like(codes, dtype=bool), ref)
    assert m[0, 4 : 4 + 27].all()


def test_quality_trim_drops_bad_tail():
    L = 60
    q = np.full((1, L), 30, dtype=np.int16)
    q[0, 50:] = 2  # bad tail
    is_n = np.zeros((1, L), dtype=bool)
    s, e = quality_trim(q, is_n, np.array([L]), trimq=10)
    assert s[0] == 0
    assert e[0] == 50


def test_quality_trim_drops_bad_head_and_tail():
    L = 60
    q = np.full((1, L), 30, dtype=np.int16)
    q[0, :5] = 2
    q[0, 55:] = 2
    s, e = quality_trim(q, is_n=np.zeros((1, L), bool), lens=np.array([L]), trimq=10)
    assert (s[0], e[0]) == (5, 55)


def test_quality_trim_all_bad():
    q = np.full((1, 40), 2, dtype=np.int16)
    s, e = quality_trim(q, np.zeros((1, 40), bool), np.array([40]))
    assert e[0] - s[0] == 0


def test_entropy_extremes():
    # homopolymer: single 5-mer repeated -> entropy 0
    codes, lens = _pack(["A" * 100])
    ent = average_entropy(codes, lens)
    assert abs(ent[0]) < 1e-12
    # random sequence: near-max entropy
    rng = np.random.default_rng(3)
    rand = "".join(rng.choice(list("ACGT")) for _ in range(100))
    codes, lens = _pack([rand])
    ent = average_entropy(codes, lens)
    assert ent[0] > 0.9
    # dinucleotide repeat: low
    codes, lens = _pack(["ACACACACAC" * 10])
    ent = average_entropy(codes, lens)
    assert ent[0] < 0.2


def test_entropy_short_read_scores_zero():
    codes, lens = _pack(["ACGTACGTAC" * 4])  # 40 < window 50
    ent = average_entropy(codes, lens)
    assert ent[0] == 0.0


def test_bbduk_pair_end_to_end():
    rng = np.random.default_rng(7)
    good = "".join(rng.choice(list("ACGT")) for _ in range(100))
    good2 = "".join(rng.choice(list("ACGT")) for _ in range(100))
    lowc = "ATATATATAT" * 10
    qual = chr(33 + 30) * 100
    badq = chr(33 + 2) * 100
    r1 = [
        FastqRecord("ok", good, qual),
        FastqRecord("low", lowc, qual),
        FastqRecord("shortq", good, badq),
    ]
    r2 = [
        FastqRecord("ok", good2, qual),
        FastqRecord("low", good2, qual),
        FastqRecord("shortq", good2, qual),
    ]
    res = bbduk_pair(r1, r2, adapters=None, min_len=50, entropy_cutoff=0.75)
    assert [r.name for r in res.kept1] == ["ok"]
    assert {r.name for r in res.low_complexity} == {"low"}
    assert res.removed_short == 1


def test_bbduk_pair_arrays_matches_record_path():
    """bbduk_pair_arrays code matrices == pack_reads over bbduk_pair's
    record output, and the lazy record views are identical — across
    adapters/kmask, quality trims, Ns, and low-complexity splits."""
    from megapath.filters.bbduk import bbduk_pair_arrays
    from megapath.index.pack import pack_reads

    rng = np.random.default_rng(11)
    adapter = "".join(rng.choice(list("ACGT")) for _ in range(31))
    adapters = build_kmer_ref([adapter], k=27, hdist=1)
    L = 120

    def mk(i):
        n = int(rng.integers(60, L + 1))
        s = "".join(rng.choice(list("ACGT")) for _ in range(n))
        if i % 4 == 0:  # embed adapter -> kmask
            p = int(rng.integers(0, n - 31))
            s = s[:p] + adapter + s[p + 31 :]
        if i % 5 == 0:  # sprinkle Ns
            q = int(rng.integers(0, n))
            s = s[:q] + "N" + s[q + 1 :]
        qual = "".join(
            chr(33 + int(rng.integers(2, 40))) for _ in range(n)
        )
        return FastqRecord(f"r{i}", s, qual)

    r1 = [mk(i) for i in range(64)]
    r2 = [mk(i + 1000) for i in range(64)]
    kw = dict(min_len=40, trimq=10, entropy_cutoff=0.75, max_len=L)
    want = bbduk_pair(r1, r2, adapters, **kw)
    got = bbduk_pair_arrays(r1, r2, adapters, **kw)

    assert got.removed == want.removed_short
    assert len(got.kept1) == len(want.kept1)
    w1, wl1 = pack_reads([r.seq for r in want.kept1], L)
    w2, wl2 = pack_reads([r.seq for r in want.kept2], L)
    np.testing.assert_array_equal(got.codes1, w1)
    np.testing.assert_array_equal(got.lens1, wl1)
    np.testing.assert_array_equal(got.codes2, w2)
    np.testing.assert_array_equal(got.lens2, wl2)
    for a, b in zip(got.kept1, want.kept1):
        assert (a.name, a.seq, a.qual) == (b.name, b.seq, b.qual)
    for a, b in zip(got.kept2, want.kept2):
        assert (a.name, a.seq, a.qual) == (b.name, b.seq, b.qual)
    for a, b in zip(got.low_complexity, want.low_complexity):
        assert (a.name, a.seq, a.qual) == (b.name, b.seq, b.qual)
