"""bbnorm golden: the vectorized normalize_pairs must reproduce the
kept-read set of the independent scalar KmerNormalize transliteration
(tests/fixtures/make_bbnorm_golden.py, a line-by-line port of
bbmap/current/jgi/KmerNormalize.java's retention decision)."""

import json
import pathlib

import numpy as np

from megapath.filters.bbnorm import (
    canonical_kmers,
    end_stats,
    normalize_pairs,
    pass_params,
)

FIX = pathlib.Path(__file__).parent / "fixtures"


def test_bbnorm_matches_transliterated_oracle():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_bbnorm_golden", FIX / "make_bbnorm_golden.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pairs = mod.make_fixture()

    golden = json.loads((FIX / "bbnorm_golden.json").read_text())
    assert golden["n_pairs"] == len(pairs)

    keep = normalize_pairs(
        [a for a, _ in pairs], [b for _, b in pairs],
        target=golden["target"], mindepth=golden["mindepth"],
        seed=golden["seed"],
    )
    kept = np.flatnonzero(keep).tolist()
    assert kept == golden["kept"], (
        f"kept-set mismatch: {len(kept)} vs {len(golden['kept'])} "
        f"(diff {set(kept) ^ set(golden['kept'])})"
    )


def test_canonical_kmers_match_oracle_and_handle_ns():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_bbnorm_golden", FIX / "make_bbnorm_golden.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    seq = "ACGTACGTAC" * 5 + "N" + "GGTTCCAAGG" * 5
    ours = canonical_kmers(seq)
    theirs = mod.to_kmers(seq, 31)
    assert ours is not None and theirs is not None
    assert ours.tolist() == theirs
    # short read
    assert canonical_kmers("ACGT") is None
    assert mod.to_kmers("ACGT", 31) is None


def test_error_reads_get_reduced_target():
    """A pair with a large fraction of depth-1 k-mers against a deep
    background must get the TARGET_DEPTH_BAD-interpolated target (the
    lowcount>0 branch)."""
    p1, pf = pass_params(target=70, mindepth=1)
    assert p1.target_depth == 280
    assert p1.target_bad_low == 60  # ceil(min(280, 70*0.85))
    assert p1.target_bad_high == 105  # ceil(min(280, 70*1.5))
    assert p1.max_depth == 350
    assert pf.target_depth == pf.target_bad_low == 70
    assert abs(p1.depth_percentile - 0.648) < 1e-3
    assert abs(pf.depth_percentile - 0.54) < 1e-9
