"""DP kernel tests: batched XLA implementation vs scalar oracle."""

import numpy as np
import pytest

from megapath.index.pack import encode_seq
from megapath.ops.dp import (
    DPParams,
    sw_align,
    sw_align_oracle,
    sw_traceback,
)


def _rand(n, rng):
    return rng.integers(0, 4, size=n).astype(np.uint8)


def _mutate(seq, rng, n_sub=0, n_ins=0, n_del=0):
    s = list(seq)
    for _ in range(n_sub):
        p = rng.integers(0, len(s))
        s[p] = (s[p] + 1 + rng.integers(0, 3)) % 4
    for _ in range(n_ins):
        p = rng.integers(0, len(s))
        s.insert(p, rng.integers(0, 4))
    for _ in range(n_del):
        p = rng.integers(0, len(s) - 1)
        del s[p]
    return np.array(s, dtype=np.uint8)


def test_exact_match_scores_len():
    rng = np.random.default_rng(0)
    ref = _rand(200, rng)
    read = ref[50:150].copy()
    score, ei, ej = sw_align_oracle(read, ref)
    assert score == 100
    assert ej == 100
    assert ei == 150


def test_oracle_affine_gap_costs():
    # single deletion of length k costs go + (k-1)*ge
    rng = np.random.default_rng(42)
    ref = _rand(40, rng)
    for k in (1, 2, 3):
        read = np.concatenate([ref[:20], ref[20 + k :]])
        score, _, _ = sw_align_oracle(read, ref)
        assert score == len(read) + (-3) + (k - 1) * (-1)


def test_oracle_mismatch_cost():
    rng = np.random.default_rng(3)
    ref = _rand(80, rng)
    read = ref[10:70].copy()
    read[30] = (read[30] + 2) % 4
    score, _, _ = sw_align_oracle(read, ref)
    assert score in (60 - 3, 59 - 2, 57)  # 59 matches + 1 mismatch = 57


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batched_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    B, R, W = 16, 48, 96
    reads = np.zeros((B, R), dtype=np.uint8)
    refs = np.zeros((B, W), dtype=np.uint8)
    read_lens = np.zeros(B, dtype=np.int32)
    ref_lens = np.zeros(B, dtype=np.int32)
    for b in range(B):
        wl = int(rng.integers(30, W + 1))
        ref = _rand(wl, rng)
        kind = b % 4
        if kind == 0:  # exact substring
            rl = int(rng.integers(20, min(wl, R) + 1))
            p = int(rng.integers(0, wl - rl + 1))
            read = ref[p : p + rl].copy()
        elif kind == 1:  # mutated substring
            rl = int(rng.integers(25, min(wl, R) + 1))
            p = int(rng.integers(0, wl - rl + 1))
            read = _mutate(ref[p : p + rl], rng, n_sub=2, n_ins=1, n_del=1)[:R]
        elif kind == 2:  # random (likely poor alignment)
            read = _rand(int(rng.integers(20, R + 1)), rng)
        else:  # read overhangs window edge (soft-clip case)
            rl = int(rng.integers(25, min(wl, R) + 1))
            read = np.concatenate([_rand(5, rng), ref[:rl - 5]])[:R]
        reads[b, : len(read)] = read
        read_lens[b] = len(read)
        refs[b, :wl] = ref
        ref_lens[b] = wl

    res = sw_align(reads, refs, read_lens, ref_lens)
    score = np.asarray(res.score)
    end_ref = np.asarray(res.end_ref)
    end_read = np.asarray(res.end_read)
    for b in range(B):
        want_s, want_i, want_j = sw_align_oracle(
            reads[b, : read_lens[b]], refs[b, : ref_lens[b]]
        )
        assert int(score[b]) == want_s, f"cand {b}"
        if want_s > 0:
            assert int(end_ref[b]) == want_i, f"cand {b}"
            assert int(end_read[b]) == want_j, f"cand {b}"


def test_padding_invariance():
    rng = np.random.default_rng(5)
    ref = _rand(60, rng)
    read = ref[10:40].copy()
    for W in (64, 128, 256):
        refs = np.zeros((1, W), dtype=np.uint8)
        refs[0, :60] = ref
        reads = np.zeros((1, 64), dtype=np.uint8)
        reads[0, :30] = read
        res = sw_align(reads, refs, np.array([30], np.int32), np.array([60], np.int32))
        assert int(np.asarray(res.score)[0]) == 30


def test_traceback_cigar():
    rng = np.random.default_rng(9)
    ref = _rand(120, rng)
    # read: 40 match, 2-del, 30 match
    read = np.concatenate([ref[20:60], ref[62:92]])
    score, ei, ej = sw_align_oracle(read, ref)
    assert score == 70 - 3 - 1
    si, sj, cigar, edit = sw_traceback(read, ref, ei, ej)
    assert si == 20
    assert sj == 0
    assert cigar == "40M2D30M"
    assert edit == 2


def test_traceback_insertion():
    rng = np.random.default_rng(11)
    ref = _rand(100, rng)
    read = np.concatenate([ref[10:40], np.array([1, 2], np.uint8), ref[40:70]])
    # force the inserted bases to mismatch their context is not needed;
    # optimal alignment is 30M 2I 30M unless insertion happens to match
    score, ei, ej = sw_align_oracle(read, ref)
    si, sj, cigar, edit = sw_traceback(read, ref, ei, ej)
    assert score >= 60 - 4
    assert si >= 0 and sj >= 0


def test_threshold_semantics():
    # both-ends keep rule: score >= max(0.2*len, 30)
    from megapath.ops.dp import DPParams

    assert max(0.2 * 100, 30) == 30
    assert max(0.2 * 200, 30) == 40


def test_traceback_batch_matches_scalar():
    """sw_traceback_batch reproduces sw_traceback per hit exactly —
    mixed clean/mutated/indel/junk reads over random windows."""
    from megapath.ops.dp import sw_traceback, sw_traceback_batch

    rng = np.random.default_rng(99)
    B, R, W = 64, 60, 96
    reads = np.zeros((B, R), np.uint8)
    wins = np.zeros((B, W), np.uint8)
    er = np.zeros(B, np.int64)
    ej = np.zeros(B, np.int64)
    for b in range(B):
        win = _rand(W, rng)
        kind = b % 4
        if kind == 0:  # clean substring
            read = win[10 : 10 + R].copy()
        elif kind == 1:  # mismatches
            read = win[5 : 5 + R].copy()
            for _ in range(4):
                q = int(rng.integers(0, R))
                read[q] = (read[q] + 1 + rng.integers(0, 3)) % 4
        elif kind == 2:  # deletion in read
            read = np.concatenate([win[8:38], win[41 : 41 + R - 30]])
        else:  # junk
            read = _rand(R, rng)
        reads[b] = read[:R]
        wins[b] = win
        from megapath.ops.dp import sw_align_oracle

        _, ei_, ej_ = sw_align_oracle(reads[b], win)
        # traceback both from the optimum and from the corner (the SAM
        # path starts at (span, read_len))
        er[b], ej[b] = (ei_, ej_) if b % 2 == 0 else (W, R)
    bsr, bsj, bcig, bed = sw_traceback_batch(reads, wins, er, ej)
    for b in range(B):
        si, sj, cig, ed = sw_traceback(
            reads[b], wins[b], int(er[b]), int(ej[b])
        )
        assert (int(bsr[b]), int(bsj[b]), bcig[b], int(bed[b])) == (
            si, sj, cig, ed
        ), f"hit {b}: {(int(bsr[b]), int(bsj[b]), bcig[b], int(bed[b]))} != {(si, sj, cig, ed)}"
