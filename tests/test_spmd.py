"""SPMD engine-in-one-program tests on the 8-device virtual mesh.

Plants paired reads (fwd left leg + revcomp right leg at a legal
insert) in known shards/species and checks the full in-program path —
FM seeding, SA locate, insert-window pairing, DP, cross-shard merge —
recovers them; also checks the distributed run matches a 1-device run
of the same program (the merge is placement-invariant).
"""

import numpy as np
import pytest

from megapath.align.params import AlignParams
from megapath.index.pack import COMPLEMENT


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[codes[::-1]].astype(np.uint8)


@pytest.fixture(scope="module")
def spmd_setup():
    from megapath.parallel.spmd import pad_and_index_shards, stack_fms

    rng = np.random.default_rng(11)
    S, M = 2, 3  # shards, sequences per shard
    seq_len = 3000
    shard_codes, seq_offsets, seq_species = [], [], []
    t = 0
    for s in range(S):
        seqs = [rng.integers(0, 4, seq_len).astype(np.uint8) for _ in range(M)]
        text = np.concatenate(seqs)
        shard_codes.append(text)
        offs = np.arange(M + 1) * seq_len
        seq_offsets.append(offs)
        seq_species.append(np.arange(t, t + M))
        t += M
    # make shard texts unequal length to exercise the padding path
    shard_codes[1] = shard_codes[1][:-500]
    fms, padded, true_n = pad_and_index_shards(
        shard_codes, sa_interval=8, lut_k=8
    )
    sfm, meta = stack_fms(fms)
    return {
        "codes": shard_codes,
        "padded": padded,
        "true_n": true_n,
        "fms": fms,
        "sfm": sfm,
        "meta": meta,
        "seq_offsets": np.stack(seq_offsets).astype(np.int32),
        "seq_species": np.stack(seq_species).astype(np.int32),
        "n_species": t,
    }


def _make_reads(setup, B, L=80, insert=200, seed=3):
    """Planted proper pairs: read b targets shard b%S, species cycles."""
    rng = np.random.default_rng(seed)
    S = len(setup["codes"])
    reads1 = np.zeros((B, L), np.uint8)
    reads2 = np.zeros((B, L), np.uint8)
    want_species = np.zeros(B, np.int64)
    for b in range(B):
        s = b % S
        text = setup["codes"][s]
        offs = setup["seq_offsets"][s]
        m = (b // S) % (len(offs) - 1)
        lo, hi = int(offs[m]), int(offs[m + 1])
        p = int(rng.integers(lo, hi - insert))
        reads1[b] = text[p : p + L]
        reads2[b] = _revcomp(text[p + insert - L : p + insert])
        want_species[b] = setup["seq_species"][s][m]
    lens = np.full(B, L, np.int32)
    return reads1, reads2, lens, want_species


def _run(setup, mesh, reads1, reads2, lens):
    from megapath.parallel.spmd import (
        build_spmd_engine_step,
        place_spmd_inputs,
    )

    step = build_spmd_engine_step(
        mesh, setup["meta"], read_len=reads1.shape[1],
        n_species=setup["n_species"],
        params=AlignParams(insert_high=400, insert_low=50),
    )
    sfm_p, placed = place_spmd_inputs(
        mesh, setup["sfm"],
        ref_codes=setup["padded"], true_n=setup["true_n"],
        seq_offsets=setup["seq_offsets"], seq_species=setup["seq_species"],
        reads1=reads1, reads2=reads2, lens1=lens, lens2=lens,
    )
    out = step(sfm_p, placed["ref_codes"], placed["true_n"],
               placed["seq_offsets"], placed["seq_species"],
               placed["reads1"], placed["reads2"],
               placed["lens1"], placed["lens2"])
    return out


def test_spmd_recovers_planted_pairs(spmd_setup):
    import jax

    from megapath.parallel.spmd import make_mesh_for

    mesh = make_mesh_for(jax.devices())
    B = 16
    reads1, reads2, lens, want = _make_reads(spmd_setup, B)
    out = _run(spmd_setup, mesh, reads1, reads2, lens)
    best = np.asarray(out.best_score)
    species = np.asarray(out.all_species)
    shard = np.asarray(out.best_shard)
    assert (best >= 2 * 0.2 * 80).all(), best
    for b in range(B):
        assert shard[b] == b % 2
        assert species[b, shard[b]] == want[b]
    # histogram counts every planted read exactly once
    hist = np.asarray(out.species_counts)
    assert hist.sum() == B
    for b in range(B):
        assert hist[want[b]] >= 1


def test_spmd_placement_invariant(spmd_setup):
    import jax
    from jax.sharding import Mesh

    from megapath.parallel.spmd import make_mesh_for

    B = 8
    reads1, reads2, lens, _ = _make_reads(spmd_setup, B, seed=5)
    mesh8 = make_mesh_for(jax.devices())
    out8 = _run(spmd_setup, mesh8, reads1, reads2, lens)
    mesh1 = Mesh(
        np.array(jax.devices()[:2]).reshape(1, 2), ("data", "shard")
    )
    out1 = _run(spmd_setup, mesh1, reads1, reads2, lens)
    np.testing.assert_array_equal(
        np.asarray(out8.best_score), np.asarray(out1.best_score)
    )
    np.testing.assert_array_equal(
        np.asarray(out8.all_species), np.asarray(out1.all_species)
    )
    np.testing.assert_array_equal(
        np.asarray(out8.kept), np.asarray(out1.kept)
    )
    np.testing.assert_array_equal(
        np.asarray(out8.species_counts), np.asarray(out1.species_counts)
    )


def test_spmd_no_false_pairs(spmd_setup):
    """Random (unplanted) reads must not produce paired hits."""
    import jax

    from megapath.parallel.spmd import make_mesh_for

    rng = np.random.default_rng(9)
    B, L = 8, 80
    reads1 = rng.integers(0, 4, (B, L)).astype(np.uint8)
    reads2 = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = np.full(B, L, np.int32)
    mesh = make_mesh_for(jax.devices())
    out = _run(spmd_setup, mesh, reads1, reads2, lens)
    assert (np.asarray(out.best_score) == 0).all()
    assert np.asarray(out.species_counts).sum() == 0


def test_spmd_report_tail(spmd_setup, mini_taxdb):
    """SPMD merged output -> Kraken report (the distributed pipeline's
    classify tail): planted species show up with the right read
    counts; junk reads count as unclassified."""
    import jax

    from megapath.parallel.spmd import make_mesh_for, spmd_report

    mesh = make_mesh_for(jax.devices())
    B = 16
    reads1, reads2, lens, want = _make_reads(spmd_setup, B)
    # 2 junk pairs on top
    rng = np.random.default_rng(13)
    reads1 = np.vstack([reads1, rng.integers(0, 4, (2, 80), np.uint8).astype(np.uint8)])
    reads2 = np.vstack([reads2, rng.integers(0, 4, (2, 80), np.uint8).astype(np.uint8)])
    lens = np.concatenate([lens, np.full(2, 80, np.int32)])
    # pad to a multiple of the data axis
    D = mesh.shape["data"]
    pad = (-len(lens)) % D
    if pad:
        reads1 = np.vstack([reads1, np.zeros((pad, 80), np.uint8)])
        reads2 = np.vstack([reads2, np.zeros((pad, 80), np.uint8)])
        lens = np.concatenate([lens, np.zeros(pad, np.int32)])
    out = _run(spmd_setup, mesh, reads1, reads2, lens)

    # species index -> real taxids from the mini taxonomy
    tids = [694009, 562, 28901, 11137, 9606, 693996][: spmd_setup["n_species"]]
    while len(tids) < spmd_setup["n_species"]:
        tids.append(694009)
    report = spmd_report(out, tids, mini_taxdb, lens, lens)
    lines = report.splitlines()
    assert lines[0].startswith("perc")
    # junk + pad pairs = 8 unclassified lines
    unclass = [l for l in lines if "unclassified" in l]
    assert unclass and int(unclass[0].split("\t")[1]) == 8, report
    # 16 planted pairs = 32 classified lines, all under root
    root = [l for l in lines if "\troot" in l][0]
    assert int(root.split("\t")[1]) == 32, report
    # per-species stay counts match the planting pattern (3,3,3,3,2,2
    # pairs over species 0..5 -> 6,6,6,6,4,4 lines)
    stays = {}
    for l in lines[1:]:
        c = l.split("\t")
        stays[int(c[4])] = int(c[2])
    assert stays[562] == 6 and stays[9606] == 6
    assert stays[28901] == 4 and stays[693996] == 4
