#!/usr/bin/env python
"""Generate the bbnorm golden kept-set by an INDEPENDENT scalar
transliteration of KmerNormalize.java's retention decision.

This oracle is deliberately written as a direct line-by-line port of
the Java (variable names and control flow follow
bbmap/current/jgi/KmerNormalize.java; citations inline), separate from
the vectorized implementation in megapath/filters/bbnorm.py — the
golden test pins the two against each other.

Coin convention shared with the implementation (documented divergence
from Java's per-read deterministic stream): numpy default_rng(seed),
one draw per surviving pair per pass, in input order.

Run: python tests/fixtures/make_bbnorm_golden.py  -> bbnorm_golden.json
"""

import json
import math
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

K = 31
BASES = "ACGT"
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def make_fixture():
    """Mixed-depth read set: deep region (~240x), mid (~60x), rare
    (~6x), error reads, a short read, an N read."""
    rng = np.random.default_rng(101)
    g = "".join(BASES[i] for i in rng.integers(0, 4, 3000))
    pairs = []
    # deep: 120 pairs from g[0:220]
    for i in range(120):
        pairs.append((g[0:100], g[120:220]))
    # mid: 30 pairs from g[300:520]
    for i in range(30):
        pairs.append((g[300:400], g[420:520]))
    # rare: 3 pairs from g[600:820]
    for i in range(3):
        pairs.append((g[600:700], g[720:820]))
    # error-read pairs: deep region with scattered mutations
    for i in range(10):
        r1 = list(g[0:100])
        for _ in range(3):
            q = int(rng.integers(0, 100))
            r1[q] = BASES[(BASES.index(r1[q]) + 1) % 4]
        pairs.append(("".join(r1), g[120:220]))
    # unique random pairs
    for i in range(8):
        pairs.append((
            "".join(BASES[i] for i in rng.integers(0, 4, 100)),
            "".join(BASES[i] for i in rng.integers(0, 4, 100)),
        ))
    # one short read pair and one N-heavy pair
    pairs.append((g[0:20], g[120:220]))
    n1 = g[0:40] + "N" * 20 + g[60:100]
    pairs.append((n1, g[120:220]))
    return pairs


def to_kmers(seq, k):
    """Read.toKmers(k, 0, kmers, true, null) — canonical = max(kmer,
    rkmer), undefined base resets len (Read.java:2924-2951)."""
    if len(seq) < k:
        return None
    shift = 2 * k
    shift2 = shift - 2
    mask = (1 << shift) - 1
    kmer = 0
    rkmer = 0
    length = 0
    kmers = [-1] * (len(seq) - k + 1)
    num = {"A": 0, "C": 1, "G": 2, "T": 3}
    for i, b in enumerate(seq):
        if b in num:
            x = num[b]
            x2 = num[COMP[b]]
            kmer = ((kmer << 2) | x) & mask
            rkmer = (rkmer >> 2) | (x2 << shift2)
            length += 1
        else:
            kmer = (kmer << 2) & mask
            rkmer = rkmer >> 2
            length = 0
        if length >= k:
            kmers[i - k + 1] = max(kmer, rkmer)
    return kmers


def count_kca(all_kmers):
    """Exact counts capped at 65535 (16-bit cells, KmerNormalize:521)."""
    t = {}
    for km in all_kmers:
        if km is None:
            continue
        for x in km:
            if x >= 0:
                t[x] = min(t.get(x, 0) + 1, 65535)
    return t


def f32(x):
    return float(np.float32(x))


def pct(last, p):
    # Java: (int)((covlast)*(1-PERCENTILE)) with float arithmetic
    return int(np.float32(last) * (np.float32(1.0) - np.float32(p)))


def run_pass(pairs, alive, P, rng):
    """One runPass decision sweep (KmerNormalize.java:2826-3020)."""
    (TARGET_DEPTH, TARGET_DEPTH_BAD_LOW, TARGET_DEPTH_BAD_HIGH,
     MAX_DEPTH, MIN_DEPTH, MIN_KMERS_OVER_MIN_DEPTH, DEPTH_PERCENTILE,
     HIGH_PERCENTILE, LOW_PERCENTILE, ERROR_DETECT_RATIO, HTHRESH,
     LTHRESH, MIN_LENGTH) = P
    idx = [i for i in range(len(pairs)) if alive[i]]
    kms = {}
    for i in idx:
        kms[(i, 0)] = to_kmers(pairs[i][0], K)
        kms[(i, 1)] = to_kmers(pairs[i][1], K)
    kca = count_kca([kms[(i, e)] for i in idx for e in (0, 1)])
    rands = rng.random(len(idx))
    keep = {}
    for j, i in enumerate(idx):
        depthAL = [-1, -1]
        truedepth = [-1, -1]
        mintruedepth = [-1, -1]
        error = [False, False]
        lowcount = 0
        totalcount = 0
        for e in (0, 1):
            km = kms[(i, e)]
            if km is None:
                continue
            cov = sorted(
                (kca.get(x, 0) if x >= 0 else -1 for x in km),
                reverse=True,
            )
            covlast = len(cov) - 1
            high = cov[pct(covlast, HIGH_PERCENTILE)]
            low = cov[pct(covlast, LOW_PERCENTILE)]
            mintruedepth[e] = low
            aboveLimit = covlast
            lc = 0
            mindepth = max(MIN_DEPTH, high // ERROR_DETECT_RATIO)
            truedepth[e] = cov[pct(covlast, DEPTH_PERCENTILE)]
            while aboveLimit >= 0 and cov[aboveLimit] < mindepth:
                aboveLimit -= 1
            if aboveLimit + 1 >= MIN_KMERS_OVER_MIN_DEPTH or (
                aboveLimit >= 0 and MIN_KMERS_OVER_MIN_DEPTH > len(cov)
            ):
                depthAL[e] = cov[pct(aboveLimit, DEPTH_PERCENTILE)]
            if (
                high <= LTHRESH
                or (high >= HTHRESH and low <= LTHRESH)
                or high >= low * ERROR_DETECT_RATIO
            ):
                error[e] = True
            totalcount += len(cov)
            if cov[0] <= LTHRESH:
                lc += len(cov)
            elif high >= HTHRESH:
                lim = min(LTHRESH, high // ERROR_DETECT_RATIO)
                ii = covlast
                while ii >= 0 and cov[ii] <= lim:
                    lc += 1
                    ii -= 1
            lowcount += lc

        maxDepth = MAX_DEPTH
        targetDepth = TARGET_DEPTH
        if lowcount > 0:
            fractionGood = f32(
                np.float32(totalcount - lowcount) / np.float32(totalcount)
            )
            targetDepth = int(
                TARGET_DEPTH_BAD_LOW
                + (TARGET_DEPTH_BAD_HIGH - TARGET_DEPTH_BAD_LOW)
                * (fractionGood * fractionGood)
            )
            maxDepth = targetDepth

        # USE_LOWER_DEPTH=true (KmerNormalize.java:3511)
        d1, d2 = depthAL
        minAL = d1 if d2 < 0 else (d2 if d1 < 0 else min(d1, d2))
        depthproxyAL = minAL
        maxTrueDepth = max(truedepth)
        coin = 0
        if depthproxyAL > maxDepth:  # error1/error2/!DISCARD_BAD_ONLY
            coin = int(rands[j] * depthproxyAL) + 1
        toss = (
            depthproxyAL < 0
            or coin > targetDepth
            or len(pairs[i][0]) < MIN_LENGTH
            or len(pairs[i][1]) < MIN_LENGTH
        )
        # TOSS_BY_LOW_TRUEDEPTH=true, SAVE_RARE_READS/REQUIRE_BOTH_BAD
        # false (KmerNormalize.java:3017-3019)
        if maxTrueDepth < MIN_DEPTH:
            toss = True
        keep[i] = not toss
    return keep


def main():
    target, mindepth = 70, 1
    pairs = make_fixture()
    rng = np.random.default_rng(7)
    alive = [True] * len(pairs)
    # pass 1 (KmerNormalize.java:655-683): tgt=4x, relaxed minDepth,
    # stretched percentile
    tgt = target * 4
    P1 = (
        tgt,
        int(math.ceil(min(tgt, target * 0.85))),
        int(math.ceil(min(tgt, target * 1.5))),
        tgt + tgt // 4,
        min(mindepth, 3),
        15,
        f32(min(np.float32(0.8), np.float32(max(0.4, 0.54)) * np.float32(1.2))),
        0.90, 0.25, 125, 12, 3, 1,
    )
    keep1 = run_pass(pairs, alive, P1, rng)
    for i, v in keep1.items():
        alive[i] = v
    # final pass (KmerNormalize.java:690-698)
    PF = (target, target, target, -1, mindepth, 15, 0.54,
          0.90, 0.25, 125, 12, 3, 1)
    keep2 = run_pass(pairs, alive, PF, rng)
    for i, v in keep2.items():
        alive[i] = v
    golden = {
        "n_pairs": len(pairs),
        "kept": [i for i in range(len(pairs)) if alive[i]],
        "target": target,
        "mindepth": mindepth,
        "seed": 7,
    }
    out = os.path.join(HERE, "bbnorm_golden.json")
    with open(out, "w") as f:
        json.dump(golden, f)
    print(f"kept {len(golden['kept'])}/{len(pairs)} -> {out}")


if __name__ == "__main__":
    main()
