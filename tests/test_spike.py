"""SPIKE filter tests incl. parity vs the reference genomeCovFilter."""

import subprocess
import pathlib

import numpy as np
import pytest

from megapath.filters.spike import (
    genome_coverage,
    overlap_fraction,
    spike_read_filter,
    spike_regions,
)

ORACLE = pathlib.Path("/tmp/refbuild/cc/genomeCovFilter")


def test_genome_coverage_runs():
    runs = genome_coverage(
        [20], np.array([0, 0]), np.array([2, 5]), np.array([8, 10])
    )
    # depth: 0..2=0, 2..5=1, 5..8=2, 8..10=1, 10..20=0
    assert runs.start.tolist() == [0, 2, 5, 8, 10]
    assert runs.stop.tolist() == [2, 5, 8, 10, 20]
    assert runs.depth.tolist() == [0, 1, 2, 1, 0]


def test_spike_regions_flags_peak():
    rng = np.random.default_rng(0)
    # uniform-ish coverage with one giant spike
    starts = rng.integers(0, 900, 300)
    aln_s = np.concatenate([starts, np.full(500, 450)])
    aln_e = np.concatenate([starts + 100, np.full(500, 550)])
    seq = np.zeros(len(aln_s), dtype=np.int32)
    runs = genome_coverage([1000], seq, aln_s, aln_e)
    s_seq, s_start, s_stop = spike_regions(runs, 1, max_depth_stdev=3)
    assert len(s_seq) > 0
    assert (s_start >= 440).all() and (s_stop <= 560).all()


def test_overlap_fraction():
    f = overlap_fraction(
        np.array([0, 0, 1]),
        np.array([0, 90, 0]),
        np.array([100, 190, 100]),
        np.array([0]),
        np.array([50]),
        np.array([150]),
    )
    np.testing.assert_allclose(f, [0.5, 0.6, 0.0])


def test_spike_read_filter_end_to_end():
    rng = np.random.default_rng(1)
    n_bg = 200
    n_spike = 300
    starts = rng.integers(0, 9900, n_bg)
    reads = np.arange(n_bg + n_spike)
    aln_s = np.concatenate([starts, np.full(n_spike, 400)])
    aln_e = np.concatenate([starts + 100, np.full(n_spike, 500)])
    seq = np.zeros(len(aln_s), dtype=np.int32)
    bad = spike_read_filter([10000], reads, seq, aln_s, aln_e, max_depth_stdev=3)
    # all spike reads flagged
    assert set(range(n_bg, n_bg + n_spike)) <= set(bad.tolist())


@pytest.mark.skipif(not ORACLE.exists(), reason="reference oracle not built")
def test_spike_regions_parity_with_oracle(tmp_path):
    rng = np.random.default_rng(5)
    seq_lens = [5000, 3000]
    aln_seq = rng.integers(0, 2, 400).astype(np.int32)
    aln_s = np.array([rng.integers(0, seq_lens[s] - 150) for s in aln_seq])
    aln_e = aln_s + 100
    # add a spike on seq 0
    aln_seq = np.concatenate([aln_seq, np.zeros(600, np.int32)])
    aln_s = np.concatenate([aln_s, np.full(600, 1200)])
    aln_e = np.concatenate([aln_e, np.full(600, 1300)])

    runs = genome_coverage(seq_lens, aln_seq, aln_s, aln_e)
    names = ["seqA", "seqB"]

    genome = tmp_path / "genome.txt"
    genome.write_text("".join(f"{n} {l}\n" for n, l in zip(names, seq_lens)))
    cov = tmp_path / "cov.bga"
    with open(cov, "w") as f:
        for i in range(len(runs.seq)):
            f.write(
                f"{names[runs.seq[i]]}\t{runs.start[i]}\t{runs.stop[i]}\t{runs.depth[i]}\n"
            )
    out = subprocess.run(
        [str(ORACLE), str(genome), str(cov), "60"],
        capture_output=True, text=True, check=True,
    ).stdout
    want = [tuple(l.split("\t")) for l in out.strip().splitlines() if l]

    s_seq, s_start, s_stop = spike_regions(runs, 2, max_depth_stdev=60)
    got = [
        (names[s_seq[i]], str(s_start[i]), str(s_stop[i]))
        for i in range(len(s_seq))
    ]
    assert got == want
