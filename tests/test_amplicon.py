"""Amplicon subsystem tests: de Bruijn haplotypes + window realignment."""

import numpy as np
import pytest

from megapath.amplicon import candidate_haplotypes, realign_window
from megapath.amplicon.debruijn import DeBruijnGraph


def _rand_seq(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def test_dbg_recovers_reference():
    ref = _rand_seq(120, 0)
    haps = candidate_haplotypes(ref, [], k=15)
    assert ref in haps


def test_dbg_recovers_snp_haplotype():
    ref = _rand_seq(150, 1)
    # reads carry a SNP at position 75
    alt = ref[:75] + ("A" if ref[75] != "A" else "C") + ref[76:]
    reads = [alt[i : i + 50] for i in range(40, 90, 3)]
    haps = candidate_haplotypes(ref, reads, k=15, min_edge_weight=2)
    assert ref in haps
    assert alt in haps


def test_dbg_recovers_deletion_haplotype():
    ref = _rand_seq(160, 2)
    alt = ref[:80] + ref[85:]  # 5bp deletion
    reads = [alt[i : i + 50] for i in range(40, 100, 4)]
    haps = candidate_haplotypes(ref, reads, k=15)
    assert alt in haps


def test_dbg_prune_drops_singleton_errors():
    ref = _rand_seq(150, 3)
    err = ref[:60] + "T" + ref[61:]  # single bad read
    haps = candidate_haplotypes(ref, [err[40:90]], k=15, min_edge_weight=2)
    assert err not in haps


def test_realign_window_prefers_alt_haplotype():
    ref = _rand_seq(200, 4)
    alt = ref[:100] + ref[103:]  # 3bp deletion
    reads = [alt[i : i + 60] for i in range(60, 130, 5)]
    out = realign_window(ref, reads, k=15)
    assert alt in out.haplotypes
    alt_idx = out.haplotypes.index(alt)
    # most reads should score best on the alt haplotype
    assert (out.best_hap == alt_idx).mean() > 0.7
    # and their projected positions should be plausible window offsets
    ok = out.read_pos[out.best_hap == alt_idx]
    assert (ok >= 0).all()


def test_realign_reads_matching_ref():
    ref = _rand_seq(200, 5)
    reads = [ref[i : i + 60] for i in range(20, 120, 10)]
    out = realign_window(ref, reads, k=15)
    ref_idx = out.haplotypes.index(ref)
    assert (out.best_hap == ref_idx).all()
    want = np.arange(20, 120, 10)
    np.testing.assert_array_equal(out.read_pos, want)


def test_update_vcf_af():
    """extract_vcf_position.py semantics: AF/DP rewrite from the
    realignment pileup (SNP / insertion / deletion alt keys)."""
    from megapath.io.vcf import find_af, update_vcf_af

    assert find_af(100, {"T": 30}, "A", "T") == 0.3
    assert find_af(100, {"IAC": 10}, "A", "AAC") == 0.1
    assert find_af(100, {"DGG": 5}, "AGG", "A") == 0.05
    assert find_af(100, {"C": 3}, "A", "T") is None

    vcf = [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS",
        "chr1\t10\t.\tA\tT\t30\tPASS\t.\tGT:GQ:DP:AF\t1/1:20:50:0.5000",
        "chr1\t99\t.\tC\tG\t30\tPASS\t.\tGT:GQ:DP:AF\t0/1:20:50:0.2000",
    ]
    table = {("chr1", 10): (80, {"T": 40})}
    out = update_vcf_af(vcf, table)
    assert out[2].endswith("1/1:20:80:0.5000")
    assert out[3] == vcf[3]  # untouched (no pileup entry)
