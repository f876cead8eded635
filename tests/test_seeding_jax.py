"""Device MMP seeder must reproduce the numpy seeder exactly."""

import numpy as np
import pytest

from megapath.align.params import MmpParams
from megapath.align.seeding import make_walkers_fast, mmp_seed
from megapath.align.seeding_jax import (
    DeviceFM,
    device_locate,
    device_mmp_seed,
)
from megapath.index.fm import build_fm_index

PARAMS = MmpParams(seed_min_length=12, reseed_len=13, good_seed_len=18)


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 4, size=n).astype(np.uint8)


@pytest.fixture(scope="module")
def world():
    codes = _rand(20000, 3)
    fm = build_fm_index(codes, sa_interval=4, lut_k=6)
    return codes, fm, DeviceFM.from_host(fm)


def _host_seed_table(walkers, wlens, fm, params):
    seeds = mmp_seed(walkers, wlens, fm, params)
    table = {}
    for i in range(len(seeds.walker)):
        table.setdefault(int(seeds.walker[i]), []).append(
            (
                int(seeds.offset[i]),
                int(seeds.length[i]),
                int(seeds.sa_lo[i]),
                int(seeds.sa_count[i]),
            )
        )
    return table


@pytest.mark.parametrize("lut", [6, 0])
def test_device_matches_host(world, lut):
    codes, fm, _ = world
    if lut != fm.lut_k:
        fm = build_fm_index(codes, sa_interval=4, lut_k=lut)
    dfm = DeviceFM.from_host(fm)
    rng = np.random.default_rng(5)
    n, L = 32, 90
    reads = np.zeros((n, L), dtype=np.uint8)
    for b in range(n):
        p = int(rng.integers(0, len(codes) - L))
        r = codes[p : p + L].copy()
        for _ in range(int(rng.integers(0, 5))):
            q = int(rng.integers(0, L))
            r[q] = (r[q] + 1 + rng.integers(0, 3)) % 4
        reads[b] = r
    lens = np.full(n, L, np.int32)
    walkers, wlens = make_walkers_fast(reads, lens)
    want = _host_seed_table(walkers, wlens, fm, PARAMS)

    out, _ = device_mmp_seed(dfm, walkers, wlens, PARAMS)
    n_seeds = np.asarray(out.n_seeds)
    off = np.asarray(out.offset)
    lng = np.asarray(out.length)
    slo = np.asarray(out.sa_lo)
    scnt = np.asarray(out.sa_count)
    for w in range(2 * n):
        got = [
            (int(off[w, j]), int(lng[w, j]), int(slo[w, j]), int(scnt[w, j]))
            for j in range(int(n_seeds[w]))
        ]
        assert got == want.get(w, []), f"walker {w}"


def test_device_locate_matches_host(world):
    codes, fm, dfm = world
    rows = np.arange(1, fm.n + 1, 37, dtype=np.int32)
    want = fm.locate(rows)
    got = np.asarray(device_locate(dfm, rows, fm.sa_interval))
    np.testing.assert_array_equal(got, want)


def test_variable_lengths(world):
    codes, fm, dfm = world
    rng = np.random.default_rng(9)
    n, L = 16, 100
    reads = np.zeros((n, L), dtype=np.uint8)
    lens = np.zeros(n, np.int32)
    for b in range(n):
        ln = int(rng.integers(10, L + 1))
        p = int(rng.integers(0, len(codes) - ln))
        reads[b, :ln] = codes[p : p + ln]
        lens[b] = ln
    walkers, wlens = make_walkers_fast(reads, lens)
    want = _host_seed_table(walkers, wlens, fm, PARAMS)
    out, _ = device_mmp_seed(dfm, walkers, wlens, PARAMS)
    n_seeds = np.asarray(out.n_seeds)
    off = np.asarray(out.offset)
    lng = np.asarray(out.length)
    for w in range(2 * n):
        got = [
            (int(off[w, j]), int(lng[w, j]))
            for j in range(int(n_seeds[w]))
        ]
        assert got == [(a, b) for a, b, _, _ in want.get(w, [])], f"walker {w}"


def test_segmented_walk_matches_single_run(world):
    """Segment + compact_walk + resume == one full-limit run."""
    import jax.numpy as jnp

    from megapath.align.seeding_jax import compact_walk

    codes, fm, dfm = world
    rng = np.random.default_rng(17)
    n, L = 48, 64
    walkers = np.zeros((n, L), np.uint8)
    wlens = np.zeros(n, np.int32)
    for i in range(n):
        ln = int(rng.integers(30, L + 1))
        if i % 3 == 0:  # junk walkers: stragglers
            walkers[i, :ln] = rng.integers(0, 4, ln)
        else:
            p = int(rng.integers(0, len(codes) - ln))
            walkers[i, :ln] = codes[p : p + ln]
            for _ in range(int(rng.integers(0, 3))):
                q = int(rng.integers(0, ln))
                walkers[i, q] = (walkers[i, q] + 1 + rng.integers(0, 3)) % 4
        wlens[i] = ln

    full, _ = device_mmp_seed(dfm, walkers, wlens, PARAMS, max_seeds=8)

    seg1 = 40
    limit = 3 * L + 64
    part, st = device_mmp_seed(
        dfm, walkers, wlens, PARAMS, max_seeds=8, max_steps=seg1,
        finalize=False,
    )
    n_seeds = np.array(part.n_seeds).astype(np.int32)
    off = np.array(part.offset).astype(np.int32)
    lng = np.array(part.length).astype(np.int32)
    slo = np.array(part.sa_lo)
    act = np.asarray(st.active)
    assert act.any(), "test needs stragglers to exercise the resume"
    idx = np.flatnonzero(act).astype(np.int32)
    pad = 16 * ((len(idx) + 15) // 16)
    idx_p = np.concatenate([idx, np.zeros(pad - len(idx), np.int32)])
    cw, cl, cst = compact_walk(
        jnp.asarray(walkers), jnp.asarray(wlens), st,
        jnp.asarray(idx_p), jnp.int32(len(idx)),
    )
    part2, _ = device_mmp_seed(
        dfm, cw, cl, PARAMS, max_seeds=8, max_steps=limit - seg1,
        state=cst, finalize=True,
    )
    n_seeds[idx] = np.asarray(part2.n_seeds).astype(np.int32)[: len(idx)]
    off[idx] = np.asarray(part2.offset).astype(np.int32)[: len(idx)]
    lng[idx] = np.asarray(part2.length).astype(np.int32)[: len(idx)]
    slo[idx] = np.asarray(part2.sa_lo)[: len(idx)]

    np.testing.assert_array_equal(n_seeds, np.asarray(full.n_seeds))
    np.testing.assert_array_equal(off, np.asarray(full.offset))
    np.testing.assert_array_equal(lng, np.asarray(full.length))
    np.testing.assert_array_equal(slo, np.asarray(full.sa_lo))


def test_staged_walk_matches_single_run(world):
    """On-device multi-segment compaction == one full-limit run, and
    the overflow flag fires when caps are too small."""
    from megapath.align.seeding_jax import device_mmp_seed_staged

    codes, fm, dfm = world
    rng = np.random.default_rng(23)
    n, L = 96, 64
    walkers = np.zeros((n, L), np.uint8)
    wlens = np.zeros(n, np.int32)
    for i in range(n):
        ln = int(rng.integers(30, L + 1))
        if i % 3 == 0:  # junk walkers: stragglers
            walkers[i, :ln] = rng.integers(0, 4, ln)
        else:
            p = int(rng.integers(0, len(codes) - ln))
            walkers[i, :ln] = codes[p : p + ln]
            for _ in range(int(rng.integers(0, 3))):
                q = int(rng.integers(0, ln))
                walkers[i, q] = (walkers[i, q] + 1 + rng.integers(0, 3)) % 4
        wlens[i] = ln

    limit = 3 * L + 64
    full, _ = device_mmp_seed(
        dfm, walkers, wlens, PARAMS, max_seeds=8, max_steps=limit
    )
    # first segment >= 2 * sibling_kill_steps + 8 (cull resolution)
    out, oflow = device_mmp_seed_staged(
        dfm, walkers, wlens, PARAMS, max_seeds=8, max_steps=limit,
        seg_plan=((112, 56), (48, 16)),
    )
    assert not bool(np.asarray(oflow))
    for name in ("offset", "length", "sa_lo", "sa_count", "n_seeds"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out, name)),
            np.asarray(getattr(full, name)),
            err_msg=name,
        )

    # cap smaller than the straggler count -> loud overflow (short
    # first segment: disable the sibling cull it cannot resolve)
    import dataclasses

    p0 = dataclasses.replace(PARAMS, sibling_kill_steps=0)
    _, oflow2 = device_mmp_seed_staged(
        dfm, walkers, wlens, p0, max_seeds=8, max_steps=limit,
        seg_plan=((8, 4),),
    )
    assert bool(np.asarray(oflow2))


@pytest.mark.parametrize("two_phase", [False, True])
def test_paired_layout_matches_host(world, two_phase):
    """The PRODUCTION walk configuration — paired 32-char occ rows,
    in both walk modes — must reproduce the host seeder exactly.
    Small test worlds auto-pick the classic layout, so without this
    forced-paired case the HBM-shard code path would go untested."""
    codes, fm, _ = world
    dfm = DeviceFM.from_host(fm, paired=True)
    assert dfm.blk < 128  # paired layout in force
    rng = np.random.default_rng(12)
    n, L = 24, 90
    reads = np.zeros((n, L), dtype=np.uint8)
    for b in range(n):
        if b % 4 == 3:
            reads[b] = rng.integers(0, 4, L)  # junk
            continue
        p = int(rng.integers(0, len(codes) - L))
        r = codes[p : p + L].copy()
        for _ in range(int(rng.integers(0, 5))):
            q = int(rng.integers(0, L))
            r[q] = (r[q] + 1 + rng.integers(0, 3)) % 4
        reads[b] = r
    lens = np.full(n, L, np.int32)
    walkers, wlens = make_walkers_fast(reads, lens)
    want = _host_seed_table(walkers, wlens, fm, PARAMS)

    out, _ = device_mmp_seed(
        dfm, walkers, wlens, PARAMS, two_phase=two_phase
    )
    n_seeds = np.asarray(out.n_seeds)
    off = np.asarray(out.offset)
    lng = np.asarray(out.length)
    slo = np.asarray(out.sa_lo)
    scnt = np.asarray(out.sa_count)
    for w in range(2 * n):
        got = [
            (int(off[w, j]), int(lng[w, j]), int(slo[w, j]), int(scnt[w, j]))
            for j in range(int(n_seeds[w]))
        ]
        assert got == want.get(w, []), f"walker {w} (two_phase={two_phase})"

    # locate through the paired layout must match the host FM too
    rows = np.asarray(
        rng.integers(1, fm.n, 256), np.int32
    )
    got_pos = np.asarray(device_locate(dfm, rows, fm.sa_interval))
    want_pos = fm.locate(rows.astype(np.int64))
    assert (got_pos == want_pos).all()
