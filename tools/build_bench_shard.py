#!/usr/bin/env python
"""Build (once, cached) the production-scale bench shard.

The toy bench shard (8 Mbp) keeps its occ/LUT tables cache-resident,
which the repo's own ablation (tools/step_ablate.py) shows understates
the per-step walk cost ~3x vs HBM-resident production tables. This
builds a >=0.5 Gbp shard — the regime the reference actually runs
(/root/reference/splitFasta.pl:19 cuts NT at 3.9 Gbp/shard) — so
bench.py can report an honest large-shard number.

Cache files are keyed by a hash of every build parameter, so layout
changes (OCC_BLOCK, lut_k, sa_interval) can never silently bench a
stale table.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CACHE = os.path.join(HERE, "bench_cache")

# one big shard: 8 sequences x 64 Mbp = 512 Mbp (NT shards hold many
# sequences; multi-seq exercises the boundary checks at scale)
BIG_SEQS = 8
BIG_SEQ_LEN = 64_000_000
BIG_PAIRS = 20_000
READ_LEN = 100
INSERT = 350
SEED = 23
LUT_K = int(os.environ.get("BIG_LUT_K", "8"))
# sa_interval 4 (was 8): the locate LF-walk is gather-latency-bound at
# sa_interval+1 lockstep iterations over the expanded position rows;
# halving the interval costs n/4 int32 samples (+256 MB at 512 Mbp)
# and halves the LF steps per locate
SA_INTERVAL = int(os.environ.get("BIG_SA_INTERVAL", "4"))


def workload_hash() -> str:
    from megapath.index.fm import OCC_BLOCK

    key = json.dumps(
        {
            "seqs": BIG_SEQS,
            "seq_len": BIG_SEQ_LEN,
            "pairs": BIG_PAIRS,
            "read_len": READ_LEN,
            "insert": INSERT,
            "seed": SEED,
            "lut_k": LUT_K,
            "sa_interval": SA_INTERVAL,
            "occ_block": OCC_BLOCK,
        },
        sort_keys=True,
    )
    return hashlib.sha256(key.encode()).hexdigest()[:10]


def paths():
    h = workload_hash()
    return (
        os.path.join(CACHE, f"big_ref_{h}.npz"),
        os.path.join(CACHE, f"big_fm_{h}.npz"),
        os.path.join(CACHE, f"big_reads_{h}.npz"),
    )


def log(msg: str) -> None:
    print(f"[big-shard] {msg}", file=sys.stderr, flush=True)


def build(force: bool = False):
    """Build + cache; returns (ref, fm, reads1, lens1, reads2, lens2)."""
    from megapath.index.fm import FMIndex, build_fm_index
    from megapath.index.pack import PackedReference

    os.makedirs(CACHE, exist_ok=True)
    ref_p, fm_p, reads_p = paths()
    if not force and all(os.path.exists(p) for p in (ref_p, fm_p, reads_p)):
        log("loading cached large shard")
        ref = PackedReference.load(ref_p)
        fm = FMIndex.load(fm_p)
        z = np.load(reads_p)
        return ref, fm, z["reads1"], z["lens1"], z["reads2"], z["lens2"]

    rng = np.random.default_rng(SEED)
    t0 = time.time()
    log(f"generating {BIG_SEQS}x{BIG_SEQ_LEN/1e6:.0f} Mbp text")
    codes = rng.integers(
        0, 4, BIG_SEQS * BIG_SEQ_LEN, dtype=np.int64
    ).astype(np.uint8)
    names = [f"bigseq{i}" for i in range(BIG_SEQS)]
    offsets = np.arange(BIG_SEQS + 1, dtype=np.int64) * BIG_SEQ_LEN
    ref = PackedReference(
        codes=codes,
        names=names,
        annotations=list(names),
        offsets=offsets,
        ambiguous=np.zeros((0, 2), np.int64),
    )

    log("building FM-index (SA-IS + occ + LUT)")
    t = time.time()
    fm = build_fm_index(codes, sa_interval=SA_INTERVAL, lut_k=LUT_K)
    log(f"index built in {time.time()-t:.0f}s")

    log("sampling reads")
    reads1 = np.zeros((BIG_PAIRS, READ_LEN), dtype=np.uint8)
    reads2 = np.zeros((BIG_PAIRS, READ_LEN), dtype=np.uint8)
    comp = np.array([3, 2, 1, 0], np.uint8)
    for i in range(BIG_PAIRS):
        s = i % BIG_SEQS
        base = s * BIG_SEQ_LEN
        p = base + int(rng.integers(0, BIG_SEQ_LEN - INSERT))
        r1 = codes[p : p + READ_LEN].copy()
        seg = codes[p + INSERT - READ_LEN : p + INSERT]
        r2 = comp[seg[::-1]].copy()
        for arr in (r1, r2):
            for _ in range(int(rng.poisson(1.0))):
                q = int(rng.integers(0, READ_LEN))
                arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
        reads1[i], reads2[i] = r1, r2
    lens = np.full(BIG_PAIRS, READ_LEN, dtype=np.int32)

    log("saving cache (uncompressed npz: multi-GB arrays)")
    t = time.time()
    ref.save(ref_p)
    # npz without compression: mark_rank alone is n*8 bytes; shrink the
    # int64 fields to the smallest dtype the values fit before writing
    np.savez(
        fm_p,
        n=fm.n,
        primary=fm.primary,
        bwt_words=fm.bwt_words,
        occ=fm.occ,
        counts=fm.counts,
        sa_sampled=fm.sa_sampled.astype(np.int64),
        mark_rank=fm.mark_rank.astype(np.int64),
        sa_interval=fm.sa_interval,
        lut_lo=fm.lut_lo,
        lut_hi=fm.lut_hi,
        lut_k=fm.lut_k,
    )
    np.savez(reads_p, reads1=reads1, lens1=lens, reads2=reads2, lens2=lens)
    log(f"saved in {time.time()-t:.0f}s; total {time.time()-t0:.0f}s")
    return ref, fm, reads1, lens, reads2, lens.copy()


if __name__ == "__main__":
    build(force="--force" in sys.argv)
    log(f"done; hash {workload_hash()}")
