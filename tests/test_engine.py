"""Alignment engine end-to-end tests on a synthetic multi-species genome."""

import numpy as np
import pytest

from megapath.align import (
    AlignEngine,
    AlignParams,
    MmpParams,
    best_per_seq,
    format_comment,
)
from megapath.index.fm import build_fm_index
from megapath.index.pack import COMPLEMENT, PackedReference, pack_fasta
from megapath.io.fastq import FastqRecord


def _rand(n, rng):
    return rng.integers(0, 4, size=n).astype(np.uint8)


DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)


def _seq_str(codes):
    return DECODE[codes].tobytes().decode()


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(99)
    seqs = {
        "ecoli_1": _rand(6000, rng),
        "salm_1": _rand(5000, rng),
        "virus_1": _rand(3000, rng),
    }
    ref = pack_fasta(
        [FastqRecord(n, _seq_str(c), "", "") for n, c in seqs.items()]
    )
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=6)
    params = AlignParams(
        insert_high=500,
        mmp=MmpParams(seed_min_length=12, reseed_len=13, good_seed_len=18),
    )
    return ref, fm, params, seqs


def _make_pairs(ref, rng, n, read_len=80, insert=300, seq_pick=None, mutate=0):
    """Proper +/- pairs: read1 = fwd at p, read2 = revcomp at
    p+insert-read_len (insert measured start-of-left to end-of-right)."""
    n_seqs = len(ref.names)
    reads1 = np.zeros((n, read_len), dtype=np.uint8)
    reads2 = np.zeros((n, read_len), dtype=np.uint8)
    truth = []
    for b in range(n):
        s = seq_pick(b) if seq_pick else int(rng.integers(0, n_seqs))
        off0, off1 = int(ref.offsets[s]), int(ref.offsets[s + 1])
        p = int(rng.integers(off0, off1 - insert))
        r1 = ref.codes[p : p + read_len].copy()
        p2 = p + insert - read_len
        r2seg = ref.codes[p2 : p2 + read_len]
        r2 = COMPLEMENT[r2seg[::-1]]
        for _ in range(mutate):
            q = int(rng.integers(0, read_len))
            r1[q] = (r1[q] + 1 + rng.integers(0, 3)) % 4
            q = int(rng.integers(0, read_len))
            r2[q] = (r2[q] + 1 + rng.integers(0, 3)) % 4
        reads1[b], reads2[b] = r1, r2
        truth.append((s, p, p2))
    lens = np.full(n, read_len, dtype=np.int32)
    return reads1, lens, reads2, lens.copy(), truth


def test_proper_pairs_align(world):
    ref, fm, params, _ = world
    rng = np.random.default_rng(5)
    engine = AlignEngine(ref, fm, params)
    r1, l1, r2, l2, truth = _make_pairs(ref, rng, 12)
    hits = engine.align_pairs(r1, l1, r2, l2)
    table = best_per_seq(hits, 12, params.megapath_mode)
    for b, (s, p, p2) in enumerate(truth):
        # both ends hit the right sequence with the paired (summed) score
        assert table[0][b].get(s) == 160, (b, table[0][b])
        assert table[1][b].get(s) == 160, (b, table[1][b])


def test_pair_positions_and_strands(world):
    ref, fm, params, _ = world
    rng = np.random.default_rng(6)
    engine = AlignEngine(ref, fm, params)
    r1, l1, r2, l2, truth = _make_pairs(ref, rng, 6)
    hits = engine.align_pairs(r1, l1, r2, l2)
    for b, (s, p, p2) in enumerate(truth):
        m1 = (hits.read == b) & (hits.end == 0) & (hits.score == 160)
        m2 = (hits.read == b) & (hits.end == 1) & (hits.score == 160)
        assert m1.any() and m2.any()
        assert p in hits.start[m1].tolist()
        assert p2 in hits.start[m2].tolist()
        assert 0 in hits.strand[m1].tolist()
        assert 1 in hits.strand[m2].tolist()


def test_mutated_pairs_score_drop(world):
    ref, fm, params, _ = world
    rng = np.random.default_rng(7)
    engine = AlignEngine(ref, fm, params)
    r1, l1, r2, l2, truth = _make_pairs(ref, rng, 8, mutate=2)
    hits = engine.align_pairs(r1, l1, r2, l2)
    table = best_per_seq(hits, 8, params.megapath_mode)
    for b, (s, p, p2) in enumerate(truth):
        sc = table[0][b].get(s, 0)
        assert 120 <= sc < 160, (b, sc)


def test_unpaired_read_mode1_vs_mode2(world):
    ref, fm, params, _ = world
    rng = np.random.default_rng(8)
    engine = AlignEngine(ref, fm, params)
    n = 4
    read_len = 80
    reads1 = np.zeros((n, read_len), dtype=np.uint8)
    reads2 = _rand(n * read_len, rng).reshape(n, read_len)  # junk mates
    truth = []
    for b in range(n):
        s = b % 3
        off0 = int(ref.offsets[s])
        p = off0 + 100 + b * 37
        reads1[b] = ref.codes[p : p + read_len]
        truth.append((s, p))
    lens = np.full(n, read_len, np.int32)
    hits = engine.align_pairs(reads1, lens, reads2, lens.copy())
    t1 = best_per_seq(hits, n, megapath_mode=1)
    t2 = best_per_seq(hits, n, megapath_mode=2)
    for b, (s, p) in enumerate(truth):
        assert t1[0][b].get(s) == 80  # unpaired single-end hit reported
        assert s not in t2[0][b]  # pair-required mode drops it


def test_cross_sequence_pairs_not_summed(world):
    """read1 on one sequence, read2 on another: ends align but are not
    properly paired, so scores stay per-end (no sum)."""
    ref, fm, params, _ = world
    rng = np.random.default_rng(9)
    read_len = 80
    p_a = int(ref.offsets[0]) + 500
    p_b = int(ref.offsets[1]) + 700
    r1 = ref.codes[p_a : p_a + read_len][None, :]
    seg = ref.codes[p_b : p_b + read_len]
    r2 = COMPLEMENT[seg[::-1]][None, :]
    lens = np.array([read_len], np.int32)
    engine = AlignEngine(ref, fm, params)
    hits = engine.align_pairs(r1, lens, r2, lens.copy())
    t = best_per_seq(hits, 1, megapath_mode=1)
    assert t[0][0].get(0) == 80
    assert t[1][0].get(1) == 80


def test_format_comment_top_filter(world):
    ref, fm, params, _ = world
    c = format_comment({0: 100, 1: 96, 2: 80}, ref, params)
    assert c.startswith("SCORE:100;")
    assert "100," + ref.names[0] in c
    assert "96," + ref.names[1] in c  # 96 >= 95
    assert ref.names[2] not in c  # 80 < 95


def test_format_comment_prev_merge(world):
    ref, fm, params, _ = world
    prev = "SCORE:120;120,OLD_REF_A;100,OLD_REF_B;"
    c = format_comment({0: 110}, ref, params, prev_comment=prev)
    # prev best 120 dominates; 110 < 114 filtered; 120 kept, 100 dropped
    assert c.startswith("SCORE:120;")
    assert "120,OLD_REF_A" in c
    assert "100,OLD_REF_B" not in c
    assert ref.names[0] not in c


def test_format_comment_ignore():
    from megapath.align.params import AlignParams

    ref = PackedReference(
        codes=np.zeros(0, np.uint8),
        names=[],
        annotations=[],
        offsets=np.array([0]),
        ambiguous=np.zeros((0, 2), np.int64),
    )
    assert format_comment({}, ref, AlignParams(), "IGNORE") == "IGNORE"


# ---------------------------------------------------------------------------
# round-2 semantics: multi-round deep DP, conditional right leg,
# insert_high window clip, single-end candidate cap
# ---------------------------------------------------------------------------


def test_multiround_aligns_on_round2(world):
    """Pairs whose reads carry a center mutation defeat a strict
    round-1 seeding (seed_min_length > longest exact stretch) but align
    on a relaxed round 2 (alignment.cpp:91-137 re-queues unaligned
    pairs through the next round's seeding parameters)."""
    ref, fm, params, _ = world
    rng = np.random.default_rng(41)
    n = 6
    r1, l1, r2, l2, truth = _make_pairs(ref, rng, n)
    # center mutation: longest exact stretch = 40 < 60
    for b in range(n):
        r1[b, 40] = (r1[b, 40] + 1) % 4
        r2[b, 40] = (r2[b, 40] + 1) % 4

    strict = MmpParams(seed_min_length=60, reseed_len=61, good_seed_len=70)
    relaxed = params.mmp

    one_round = AlignEngine(ref, fm, params.with_(mmp=strict))
    hits1 = one_round.align_pairs(r1, l1, r2, l2)
    assert len(hits1) == 0

    two_round = AlignEngine(
        ref, fm, params.with_(mmp=strict, extra_rounds=(relaxed,))
    )
    hits2 = two_round.align_pairs(r1, l1, r2, l2)
    table = best_per_seq(hits2, n, megapath_mode=1)
    for b, (s, p, p2) in enumerate(truth):
        # 79 matches + 1 mismatch per end: 77 per end, 154 paired
        assert table[0][b].get(s) == 154, (b, table[0][b])
        assert table[1][b].get(s) == 154


def test_right_window_clipped_at_insert_high(world):
    """A candidate whose right leg extends past leftStart + insert_high
    gets its window clipped (DV-DPfunctions.cpp:2954-2959): the
    overhanging tail is soft-clipped out of the score."""
    ref, fm, params, _ = world
    rng = np.random.default_rng(42)
    read_len = 80
    # insert 520 > insert_high 500, but within the pairing margin
    # (right_pos = p+440 <= p + 500 - 80 + 25)
    r1, l1, r2, l2, truth = _make_pairs(ref, rng, 4, insert=520)
    engine = AlignEngine(ref, fm, params)
    hits = engine.align_pairs(r1, l1, r2, l2)
    table = best_per_seq(hits, 4, megapath_mode=1)
    for b, (s, p, p2) in enumerate(truth):
        # left leg full 80; right leg loses the 20 bases past p+500
        assert table[0][b].get(s) == 140, (b, table[0][b])
        assert table[1][b].get(s) == 140


def test_single_end_candidate_cap(world):
    """max_se_candidates bounds the single-end DP fan-out per read end
    (DV-DPForSingleReads.cpp:200 caps at the first 200 per readID)."""
    ref, fm, params, _ = world
    rng = np.random.default_rng(43)
    read_len = 80
    # a motif repeated 10x in sequence 0 -> ~10 candidate clusters
    motif = _rand(read_len, rng)
    codes = ref.codes.copy()
    spots = [200 + 400 * k for k in range(10)]
    for q in spots:
        codes[q : q + read_len] = motif
    ref2 = PackedReference(
        codes=codes, names=ref.names, annotations=ref.annotations,
        offsets=ref.offsets, ambiguous=ref.ambiguous,
    )
    from megapath.index.fm import build_fm_index

    fm2 = build_fm_index(codes, sa_interval=4, lut_k=6)
    reads1 = motif[None, :].copy()
    reads2 = _rand(read_len, rng)[None, :]  # junk mate: no pairing
    lens = np.full(1, read_len, np.int32)

    uncapped = AlignEngine(ref2, fm2, params)
    h_all = uncapped.align_pairs(reads1, lens, reads2, lens.copy())
    n_all = len(np.unique(h_all.start[(h_all.read == 0) & (h_all.end == 0)]))
    assert n_all == 10

    capped = AlignEngine(ref2, fm2, params.with_(max_se_candidates=2))
    h_cap = capped.align_pairs(reads1, lens, reads2, lens.copy())
    n_cap = len(np.unique(h_cap.start[(h_cap.read == 0) & (h_cap.end == 0)]))
    assert n_cap <= 2


def test_pipelined_batch_path_matches_plain(world):
    """The software-pipelined chunk path (seed-walk overlap) must
    produce exactly the plain path's hits."""
    import numpy as np

    from megapath.align.engine import BatchHits

    ref, fm, params, seqs = world
    engine = AlignEngine(ref, fm, params, device_seeding=True)
    rng = np.random.default_rng(17)
    n, L = 96, 80
    keys = list(seqs)
    reads1 = np.zeros((n, L), np.uint8)
    reads2 = np.zeros((n, L), np.uint8)
    for i in range(n):
        c = seqs[keys[i % len(keys)]]
        if i % 5 == 4:  # junk pair
            reads1[i] = rng.integers(0, 4, L)
            reads2[i] = rng.integers(0, 4, L)
            continue
        p = int(rng.integers(0, len(c) - 300))
        reads1[i] = c[p : p + L]
        seg = c[p + 300 - L : p + 300]
        reads2[i] = np.array([3, 2, 1, 0], np.uint8)[seg[::-1]]
    lens = np.full(n, L, np.int32)

    engine.chunk_pairs = 0
    want = engine._align_pairs_impl(reads1, lens, reads2, lens)
    engine.chunk_pairs = 32  # force 3 chunks
    got = engine.align_pairs(reads1, lens, reads2, lens)
    engine.chunk_pairs = 8192

    def canon(h: BatchHits):
        order = np.lexsort((h.strand, h.start, h.seq, h.end, h.read))
        return [
            np.asarray(getattr(h, f))[order]
            for f in ("read", "end", "seq", "score", "raw_score",
                      "start", "stop", "strand", "paired")
        ]

    for a, b in zip(canon(want), canon(got)):
        np.testing.assert_array_equal(a, b)


def test_staged_seed_compact_matches_plain(world):
    """The on-device staged seeding walk (straggler compaction) must
    produce exactly the plain walk's hits through the engine."""
    import numpy as np

    from megapath.align.engine import BatchHits

    ref, fm, params, seqs = world
    engine = AlignEngine(ref, fm, params, device_seeding=True)
    rng = np.random.default_rng(29)
    n, L = 96, 80
    keys = list(seqs)
    reads1 = np.zeros((n, L), np.uint8)
    reads2 = np.zeros((n, L), np.uint8)
    for i in range(n):
        c = seqs[keys[i % len(keys)]]
        if i % 5 == 4:  # junk pair (stragglers)
            reads1[i] = rng.integers(0, 4, L)
            reads2[i] = rng.integers(0, 4, L)
            continue
        p = int(rng.integers(0, len(c) - 300))
        reads1[i] = c[p : p + L]
        seg = c[p + 300 - L : p + 300]
        reads2[i] = np.array([3, 2, 1, 0], np.uint8)[seg[::-1]]
    lens = np.full(n, L, np.int32)

    engine.seed_compact = False
    want = engine.align_pairs(reads1, lens, reads2, lens)
    engine.seed_compact = True
    engine.seed_compact_min = 0  # force the staged path at this size
    got = engine.align_pairs(reads1, lens, reads2, lens)

    def canon(h: BatchHits):
        order = np.lexsort((h.strand, h.start, h.seq, h.end, h.read))
        return [
            np.asarray(getattr(h, f))[order]
            for f in ("read", "end", "seq", "score", "raw_score",
                      "start", "stop", "strand", "paired")
        ]

    for a, b in zip(canon(want), canon(got)):
        np.testing.assert_array_equal(a, b)


def test_exact_rescue_modes_agree_when_dial_is_lossless():
    """On a world where the dial loses nothing (small genome), the
    rescued, dial-only, and direct-exact modes must produce identical
    hit sets — the rescue is a no-op, not a perturbation."""
    import numpy as np

    from megapath.align import AlignEngine, AlignParams
    from megapath.index.fm import build_fm_index
    from megapath.index.pack import pack_fasta
    from megapath.io.fastq import FastqRecord

    rng = np.random.default_rng(8)
    decode = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = rng.integers(0, 4, 60_000).astype(np.uint8)
    ref = pack_fasta([FastqRecord("g", decode[g].tobytes().decode(), "")])
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
    comp = np.array([3, 2, 1, 0], np.uint8)
    n, L, ins = 40, 100, 300
    r1 = np.zeros((n, L), np.uint8)
    r2 = np.zeros((n, L), np.uint8)
    for i in range(n):
        p = int(rng.integers(0, len(g) - ins))
        r1[i] = g[p : p + L]
        r2[i] = comp[g[p + ins - L : p + ins][::-1]]
        if i % 3 == 0:  # junk pair: random bases, no hits anywhere
            r1[i] = rng.integers(0, 4, L)
            r2[i] = rng.integers(0, 4, L)
    lens = np.full(n, L, np.int32)

    def hitset(engine):
        h = engine.align_pairs(r1, lens, r2, lens)
        return {
            (int(a), int(b), int(c), int(d), int(e))
            for a, b, c, d, e in zip(h.read, h.end, h.score, h.start, h.stop)
        }

    e1 = AlignEngine(ref, fm, AlignParams(), device_seeding=True)
    want = hitset(e1)
    e2 = AlignEngine(ref, fm, AlignParams(), device_seeding=True)
    e2.exact_rescue = False
    assert hitset(e2) == want
    e3 = AlignEngine(ref, fm, AlignParams(), device_seeding=True)
    got_direct = {
        (int(a), int(b), int(c), int(d), int(e))
        for a, b, c, d, e in zip(
            *(getattr(e3._run_exact(r1, lens, r2, lens), f)
              for f in ("read", "end", "score", "start", "stop"))
        )
    }
    assert got_direct == want
