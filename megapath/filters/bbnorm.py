"""Digital normalization to a target depth (bbnorm / KmerNormalize).

Faithful transliteration of the retention decision of
``bbmap/current/jgi/KmerNormalize.java`` as invoked by the driver
(``runMegaPath.sh:279``: interleaved pairs, ``target=70 mindepth=1``,
default ``passes=2``):

* canonical k-mers (max of fwd/revcomp, ``Read.toKmers:2947``), k=31,
  N-containing k-mers -> -1 (skipped);
* per-end coverage = per-k-mer counts, sorted DESCENDING
  (``sortCoverageAndIncrementHistogram:3359``);
* per-end stats (``KmerNormalize.java:2859-2887``): high/low/true-depth
  percentile picks (float32 index arithmetic like Java's float),
  ``depthAL`` = depth at the percentile over k-mers >= localized min
  depth, error flags, low-k-mer counting;
* per-pair decision (``:2974-3020``): error-fraction-adjusted target,
  lower-end depth proxy (USE_LOWER_DEPTH), a depth-proportional coin
  (kept iff coin <= target), TOSS_BY_LOW_TRUEDEPTH;
* two passes (``:646-698``): pass 1 at 4x target with relaxed
  min-depth and stretched percentile, table rebuilt from survivors,
  then the final pass at the true target.

Deliberate divergences (documented, pinned by the golden test
``tests/test_bbnorm_golden.py`` against an independently transliterated
scalar oracle):
* exact k-mer counts capped at 65535 stand in for the KCountArray
  count-min sketch (the sketch's collision overestimates depend on
  -Xmx; an exact table is its infinite-memory limit);
* the per-pair coin uses a seeded numpy stream in input order instead
  of Java's deterministic per-read stream (same distribution, both
  reproducible);
* percentile indices use float32 like Java floats, so index choices
  match the reference arithmetic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from megapath.index.pack import encode_seq

K = 31
CBITS_CAP = 65535  # 16-bit KCountArray cells (KmerNormalize.java:521)


@dataclass(frozen=True)
class PassParams:
    """One runPass parameterization (KmerNormalize.java:841-864)."""

    target_depth: int
    target_bad_low: int
    target_bad_high: int
    max_depth: int
    min_depth: int
    min_kmers_over_min_depth: int
    depth_percentile: float
    high_percentile: float = 0.90
    low_percentile: float = 0.25
    error_detect_ratio: int = 125
    hthresh: int = 12
    lthresh: int = 3
    min_length: int = 1


def pass_params(target: int = 70, mindepth: int = 1,
                min_kmers: int = 15) -> Tuple[PassParams, PassParams]:
    """The two passes=2 parameterizations (KmerNormalize.java:646-698)."""
    dp = 0.54
    tgt1 = target * 4
    p1 = PassParams(
        target_depth=tgt1,
        target_bad_low=int(math.ceil(min(tgt1, target * 0.85))),
        target_bad_high=int(math.ceil(min(tgt1, target * 1.5))),
        max_depth=tgt1 + tgt1 // 4,
        min_depth=min(mindepth, 3),
        min_kmers_over_min_depth=min_kmers,
        depth_percentile=float(
            np.minimum(np.float32(0.8), np.float32(max(0.4, dp)) * np.float32(1.2))
        ),
    )
    pf = PassParams(
        target_depth=target,
        target_bad_low=target,
        target_bad_high=target,
        max_depth=-1,
        min_depth=mindepth,
        min_kmers_over_min_depth=min_kmers,
        depth_percentile=dp,
    )
    return p1, pf


_COMP = np.array([3, 2, 1, 0], dtype=np.int64)


def canonical_kmers(seq: str, k: int = K) -> Optional[np.ndarray]:
    """int64 canonical (max of fwd/rc) k-mers, -1 where any base is
    N/invalid; None when len(seq) < k (Read.toKmers:2924-2951)."""
    n = len(seq)
    if n < k:
        return None
    codes = encode_seq(seq).astype(np.int64)
    raw = np.frombuffer(seq.encode(), dtype=np.uint8)
    defined = np.isin(raw, np.frombuffer(b"ACGTacgt", np.uint8))
    fwd = np.zeros(n - k + 1, dtype=np.int64)
    rc = np.zeros(n - k + 1, dtype=np.int64)
    # rolling build, vectorized over windows via strided cumulation
    val = 0
    rval = 0
    mask = (1 << (2 * k)) - 1
    out_f = np.empty(n - k + 1, dtype=np.int64)
    out_r = np.empty(n - k + 1, dtype=np.int64)
    comp = _COMP
    for i in range(n):
        val = ((val << 2) | int(codes[i])) & mask
        rval = (rval >> 2) | (int(comp[codes[i]]) << (2 * (k - 1)))
        if i >= k - 1:
            out_f[i - k + 1] = val
            out_r[i - k + 1] = rval
    fwd, rc = out_f, out_r
    km = np.maximum(fwd, rc)
    # N handling: a k-mer is valid iff all its bases are defined
    ok = (
        np.convolve(defined.astype(np.int64), np.ones(k, dtype=np.int64), "valid")
        == k
    )
    return np.where(ok, km, np.int64(-1))


def count_table(kmer_lists: Sequence[Optional[np.ndarray]]) -> Dict[int, int]:
    """Exact canonical-k-mer counts capped at 65535 (the
    infinite-memory limit of the 16-bit KCountArray)."""
    parts = [a[a >= 0] for a in kmer_lists if a is not None]
    if not parts:
        return {}
    allk = np.concatenate(parts)
    uniq, cnt = np.unique(allk, return_counts=True)
    cnt = np.minimum(cnt, CBITS_CAP)
    return dict(zip(uniq.tolist(), cnt.tolist()))


def _pct_idx(last: int, p: float) -> int:
    """Java float index arithmetic: (int)(last * (1 - p))."""
    return int(np.float32(last) * (np.float32(1.0) - np.float32(p)))


@dataclass
class EndStats:
    """Per-end coverage statistics (KmerNormalize.java:2850-2887)."""

    depth_al: int = -1
    truedepth: int = -1
    mintruedepth: int = -1
    error: bool = False
    lowcount: int = 0
    totalcount: int = 0
    has_cov: bool = False


def end_stats(km: Optional[np.ndarray], counts: Dict[int, int],
              p: PassParams) -> EndStats:
    st = EndStats()
    if km is None or len(km) == 0:
        return st
    cov = np.array(
        [counts.get(int(x), 0) if x >= 0 else -1 for x in km],
        dtype=np.int64,
    )
    cov = np.sort(cov)[::-1]  # descending (sortCoverageAndIncrement...)
    st.has_cov = True
    last = len(cov) - 1
    high = int(cov[_pct_idx(last, p.high_percentile)])
    low = int(cov[_pct_idx(last, p.low_percentile)])
    st.mintruedepth = low
    mindepth = max(p.min_depth, high // p.error_detect_ratio)
    st.truedepth = int(cov[_pct_idx(last, p.depth_percentile)])
    above = last
    while above >= 0 and cov[above] < mindepth:
        above -= 1
    if above + 1 >= p.min_kmers_over_min_depth or (
        above >= 0 and p.min_kmers_over_min_depth > len(cov)
    ):
        st.depth_al = int(cov[_pct_idx(above, p.depth_percentile)])
    st.error = (
        high <= p.lthresh
        or (high >= p.hthresh and low <= p.lthresh)
        or high >= low * p.error_detect_ratio
    )
    st.totalcount = len(cov)
    lc = 0
    if cov[0] <= p.lthresh:
        lc = len(cov)
    elif high >= p.hthresh:
        lim = min(p.lthresh, high // p.error_detect_ratio)
        i = last
        while i >= 0 and cov[i] <= lim:
            lc += 1
            i -= 1
    st.lowcount = lc
    return st


def decide_pair(
    s1: EndStats, s2: EndStats, len1: int, len2: int,
    p: PassParams, rand: float,
) -> bool:
    """True = KEEP (KmerNormalize.java:2974-3020, defaults:
    USE_LOWER_DEPTH, TOSS_BY_LOW_TRUEDEPTH on; TOSS_ERROR_READS,
    DISCARD_BAD_ONLY, REQUIRE_BOTH_BAD, SAVE_RARE_READS, KEEP_ALL
    off)."""
    lowcount = s1.lowcount + s2.lowcount
    totalcount = s1.totalcount + s2.totalcount
    max_depth = p.max_depth
    target = p.target_depth
    if lowcount > 0:
        fg = np.float32(totalcount - lowcount) / np.float32(totalcount)
        target = int(
            p.target_bad_low
            + (p.target_bad_high - p.target_bad_low) * float(fg * fg)
        )
        max_depth = target

    d1, d2 = s1.depth_al, s2.depth_al
    min_al = d1 if d2 < 0 else (d2 if d1 < 0 else min(d1, d2))
    depthproxy = min_al  # USE_LOWER_DEPTH
    max_truedepth = max(s1.truedepth, s2.truedepth)

    coin = 0
    if depthproxy > max_depth:
        coin = int(rand * depthproxy) + 1

    toss = (
        depthproxy < 0
        or coin > target
        or len1 < p.min_length
        or len2 < p.min_length
    )
    # TOSS_BY_LOW_TRUEDEPTH (REQUIRE_BOTH_BAD false)
    if max_truedepth < p.min_depth:
        toss = True
    return not toss


def normalize_pairs(
    seqs1: Sequence[str],
    seqs2: Sequence[str],
    target: int = 70,
    k: int = K,
    seed: int = 7,
    mindepth: int = 1,
    passes: int = 2,
) -> np.ndarray:
    """Keep mask over pairs — the two-pass KmerNormalize flow: pass 1
    decides at 4x target on counts over ALL pairs, the final pass
    decides at the true target on counts rebuilt from pass-1
    survivors (KmerNormalize.java:646-698)."""
    n = len(seqs1)
    p1, pf = pass_params(target=target, mindepth=mindepth)
    plan = [pf] if passes <= 1 else [p1, pf]
    alive = np.ones(n, dtype=bool)
    rng = np.random.default_rng(seed)
    for p in plan:
        idx = np.flatnonzero(alive)
        km1 = [canonical_kmers(seqs1[i], k) for i in idx]
        km2 = [canonical_kmers(seqs2[i], k) for i in idx]
        counts = count_table(km1 + km2)
        rands = rng.random(len(idx))
        keep = np.zeros(len(idx), dtype=bool)
        for j, i in enumerate(idx):
            s1 = end_stats(km1[j], counts, p)
            s2 = end_stats(km2[j], counts, p)
            keep[j] = decide_pair(
                s1, s2, len(seqs1[i]), len(seqs2[i]), p, rands[j]
            )
        alive[idx[~keep]] = False
    return alive
