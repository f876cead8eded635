"""MMP seeding tests: batched state machine vs a scalar reference walk."""

import numpy as np
import pytest

from megapath.align.params import MmpParams
from megapath.align.seeding import (
    decode_seeds,
    make_walkers_fast,
    mmp_seed,
)
from megapath.index.fm import build_fm_index
from megapath.index.pack import COMPLEMENT, encode_seq


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 4, size=n).astype(np.uint8)


def scalar_mmp(seq, fm, p: MmpParams):
    """Direct scalar port of the documented mmp<0> walk (see
    seeding.py docstring) used as the batched machine's oracle."""
    L = len(seq)
    k = fm.lut_k
    n_rows = fm.n + 1
    out = []
    i, lo, hi, sl = 0, 0, n_rows, 0
    last = (0, n_rows, 0)

    def emit(at_i):
        nonlocal i, lo, hi, sl, last
        diff = 0
        if sl >= p.seed_min_length:
            llo, lhi, llen = last
            if (
                sl >= p.reseed_len
                and (lhi - llo) <= p.sa_size_threshold
                and ((sl - llen) <= p.reseed_abs_diff or sl * p.reseed_rlt_ratio < llen)
            ):
                diff = sl - llen
                lo, hi, sl = llo, lhi, llen
        if sl >= p.seed_min_length:
            out.append((L - at_i, sl, lo, min(hi - lo, p.sa_size_threshold + 1)))
        i -= diff + min(sl, p.seed_min_length)
        lo, hi, sl = 0, n_rows, 0
        last = (0, n_rows, 0)

    while i < L:
        if sl == 0:
            if L - i < p.seed_min_length:
                break
            if k:
                j0 = L - i - k
                v = 0
                for c in seq[j0 : j0 + k]:
                    v = v * 4 + int(c)
                nlo, nhi = fm.lut_interval(np.array([v]))
                nlo, nhi = int(nlo[0]), int(nhi[0])
                i += k - 1
                sl = k - 1
            else:
                c = seq[L - 1 - i]
                nlo, nhi = fm.extend_backward(
                    np.array([lo]), np.array([hi]), np.array([c])
                )
                nlo, nhi = int(nlo[0]), int(nhi[0])
        else:
            c = seq[L - 1 - i]
            nlo, nhi = fm.extend_backward(
                np.array([lo]), np.array([hi]), np.array([c])
            )
            nlo, nhi = int(nlo[0]), int(nhi[0])
        if nlo < nhi:
            if sl >= p.seed_min_length and (nhi - nlo) < (hi - lo):
                last = (lo, hi, sl)
            lo, hi, sl = nlo, nhi, sl + 1
        else:
            emit(i)
        i += 1
    if sl > 0 and i >= L:
        emit(L)
    return out


# the scalar oracle has no step model, so the batched machine's
# step-budget dials (kill_ratio / junk_kill_steps) are disabled here;
# device-vs-host parity WITH the dials runs in test_seeding_jax
PARAMS = MmpParams(
    seed_min_length=12, reseed_len=13, good_seed_len=18,
    kill_ratio=0.0, sibling_kill_steps=0,
)


@pytest.fixture(scope="module")
def genome_fm():
    codes = _rand(8000, 3)
    fm = build_fm_index(codes, sa_interval=4, lut_k=6)
    return codes, fm


def test_exact_read_single_seed(genome_fm):
    codes, fm = genome_fm
    read = codes[1000:1060].copy()
    reads = read[None, :]
    walkers, wl = make_walkers_fast(reads, np.array([60], np.int32))
    seeds = mmp_seed(walkers, wl, fm, PARAMS)
    fw = seeds.walker == 0
    assert fw.any()
    # the longest forward seed should span the whole read
    best = np.argmax(seeds.length[fw])
    assert seeds.length[fw][best] == 60
    assert seeds.offset[fw][best] == 0


def test_batched_matches_scalar(genome_fm):
    codes, fm = genome_fm
    rng = np.random.default_rng(17)
    L = 80
    n = 24
    reads = np.zeros((n, L), dtype=np.uint8)
    for b in range(n):
        p = int(rng.integers(0, len(codes) - L))
        r = codes[p : p + L].copy()
        # sprinkle mutations to force restarts
        for _ in range(int(rng.integers(0, 4))):
            q = int(rng.integers(0, L))
            r[q] = (r[q] + 1 + rng.integers(0, 3)) % 4
        reads[b] = r
    lens = np.full(n, L, dtype=np.int32)
    walkers, wl = make_walkers_fast(reads, lens)
    seeds = mmp_seed(walkers, wl, fm, PARAMS)
    for w in range(2 * n):
        got = sorted(
            zip(
                seeds.offset[seeds.walker == w].tolist(),
                seeds.length[seeds.walker == w].tolist(),
                seeds.sa_lo[seeds.walker == w].tolist(),
                seeds.sa_count[seeds.walker == w].tolist(),
            )
        )
        want = sorted(scalar_mmp(walkers[w, : wl[w]], fm, PARAMS))
        assert got == want, f"walker {w}: {got} != {want}"


def test_decode_positions(genome_fm):
    codes, fm = genome_fm
    p0 = 2345
    read = codes[p0 : p0 + 70].copy()
    reads = read[None, :]
    lens = np.array([70], np.int32)
    walkers, wl = make_walkers_fast(reads, lens)
    seeds = mmp_seed(walkers, wl, fm, PARAMS)
    sp = decode_seeds(seeds, fm, lens, 1, PARAMS)
    fw = sp.strand == 0
    assert p0 in sp.pos[fw].tolist()


def test_revcomp_strand_position(genome_fm):
    codes, fm = genome_fm
    p0 = 4321
    L = 70
    # read = revcomp of text segment -> aligns on - strand at p0
    seg = codes[p0 : p0 + L]
    read = COMPLEMENT[seg[::-1]]
    reads = read[None, :]
    lens = np.array([L], np.int32)
    walkers, wl = make_walkers_fast(reads, lens)
    seeds = mmp_seed(walkers, wl, fm, PARAMS)
    sp = decode_seeds(seeds, fm, lens, 1, PARAMS)
    rv = sp.strand == 1
    assert p0 in sp.pos[rv].tolist()


def test_mutated_read_multiple_seeds(genome_fm):
    codes, fm = genome_fm
    p0 = 3000
    read = codes[p0 : p0 + 80].copy()
    read[40] = (read[40] + 2) % 4  # SNP splits the MMP walk
    reads = read[None, :]
    lens = np.array([80], np.int32)
    walkers, wl = make_walkers_fast(reads, lens)
    seeds = mmp_seed(walkers, wl, fm, PARAMS)
    fw = seeds.walker == 0
    assert fw.sum() >= 2  # at least one seed per side of the SNP
    sp = decode_seeds(seeds, fm, lens, 1, PARAMS)
    assert p0 in sp.pos[sp.strand == 0].tolist()
