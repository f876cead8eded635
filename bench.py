#!/usr/bin/env python
"""megapath benchmark: reads/s per GPU aligning against an NT-style shard.

Refuses to run on any backend but ``gpu``. Prints ONE JSON line:
  {"metric": "align_reads_per_sec_per_chip", "value": N,
   "unit": "reads/s", "vs_baseline": ratio, "device": {...}, ...}

``value`` is the STEADY-STATE number: the median of 3 post-warmup
passes (the best pass rides in ``best``). Two workloads run:

* toy shard (8 Mbp, cache-resident occ tables): the historical
  headline, comparable to bench_baseline.json (reference soap4
  measured on this machine with the same workload).
* large shard (512 Mbp, HBM-resident occ tables — the regime the
  reference actually runs, splitFasta.pl:19 cuts NT at 3.9 Gbp):
  ``large_shard_reads_per_sec`` plus a walk/locate/rest breakdown.

All cache files are keyed by a hash of the build parameters, so an
index-layout change can never silently bench stale tables.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
CACHE = os.path.join(HERE, "bench_cache")

GENOME_SEQS = 4
GENOME_LEN = 2_000_000
N_PAIRS = 20_000
READ_LEN = 100
INSERT = 350
SEED = 11
LUT_K = int(os.environ.get("BENCH_LUT_K", "8"))
SA_INTERVAL = 8


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def toy_hash() -> str:
    from megapath.index.fm import OCC_BLOCK

    key = json.dumps(
        {
            "seqs": GENOME_SEQS, "seq_len": GENOME_LEN, "pairs": N_PAIRS,
            "read_len": READ_LEN, "insert": INSERT, "seed": SEED,
            "lut_k": LUT_K, "sa_interval": SA_INTERVAL,
            "occ_block": OCC_BLOCK,
        },
        sort_keys=True,
    )
    return hashlib.sha256(key.encode()).hexdigest()[:10]


def build_workload():
    from megapath.index.fm import FMIndex, build_fm_index
    from megapath.index.pack import PackedReference, pack_fasta
    from megapath.io.fastq import FastqRecord

    os.makedirs(CACHE, exist_ok=True)
    h = toy_hash()
    ref_p = os.path.join(CACHE, f"ref_{h}.npz")
    fm_p = os.path.join(CACHE, f"fm_{h}.npz")
    reads_p = os.path.join(CACHE, f"reads_{h}.npz")

    if all(os.path.exists(p) for p in (ref_p, fm_p, reads_p)):
        log(f"loading cached toy workload ({h})")
        ref = PackedReference.load(ref_p)
        fm = FMIndex.load(fm_p)
        z = np.load(reads_p)
        return ref, fm, z["reads1"], z["lens1"], z["reads2"], z["lens2"]

    log("building toy workload (one-time)")
    rng = np.random.default_rng(SEED)
    decode = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = {
        f"seq{i}": rng.integers(0, 4, GENOME_LEN).astype(np.uint8)
        for i in range(GENOME_SEQS)
    }
    recs = [
        FastqRecord(k, decode[v].tobytes().decode(), "", "") for k, v in seqs.items()
    ]
    ref = pack_fasta(recs)
    t = time.time()
    # lut_k=8, NOT the reference's LOOKUP_SIZE=13: the 4^13 LUT (536
    # MB) makes every fresh-walker gather a cold device-memory row, and
    # the lockstep loop cannot cash in soap4's empty-bucket early exits;
    # 65k buckets stay cache-resident (to be re-swept on the card,
    # ROADMAP A6)
    fm = build_fm_index(ref.codes, sa_interval=SA_INTERVAL, lut_k=LUT_K)
    log(f"index built in {time.time()-t:.1f}s")
    ref.save(ref_p)
    fm.save(fm_p)

    keys = list(seqs)
    reads1 = np.zeros((N_PAIRS, READ_LEN), dtype=np.uint8)
    reads2 = np.zeros((N_PAIRS, READ_LEN), dtype=np.uint8)
    for i in range(N_PAIRS):
        c = seqs[keys[i % GENOME_SEQS]]
        p = int(rng.integers(0, len(c) - INSERT))
        r1 = c[p : p + READ_LEN].copy()
        seg = c[p + INSERT - READ_LEN : p + INSERT]
        r2 = np.array([3, 2, 1, 0], np.uint8)[seg[::-1]].copy()
        for arr in (r1, r2):
            for _ in range(int(rng.poisson(1.0))):
                q = int(rng.integers(0, READ_LEN))
                arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
        reads1[i], reads2[i] = r1, r2
    lens = np.full(N_PAIRS, READ_LEN, dtype=np.int32)
    np.savez_compressed(
        reads_p, reads1=reads1, lens1=lens, reads2=reads2, lens2=lens
    )
    return ref, fm, reads1, lens, reads2, lens.copy()


def _bench_taxdb(ref):
    """Synthetic 4-species taxonomy for the pipeline bench."""
    from megapath.taxonomy.taxdb import TaxDB

    nodes_p = os.path.join(CACHE, "nodes.dmp")
    names_p = os.path.join(CACHE, "names.dmp")
    acc_p = os.path.join(CACHE, "acc2tid.map")
    if not os.path.exists(acc_p):
        with open(nodes_p, "w") as f:
            f.write("1\t|\t1\t|\tno rank\t|\t\n")
            f.write("2\t|\t1\t|\tsuperkingdom\t|\t\n")
            for i in range(GENOME_SEQS):
                f.write(f"{10+i}\t|\t2\t|\tspecies\t|\t\n")
        with open(names_p, "w") as f:
            f.write("1\t|\troot\t|\t\t|\tscientific name\t|\n")
            f.write("2\t|\tBacteria\t|\t\t|\tscientific name\t|\n")
            for i in range(GENOME_SEQS):
                f.write(f"{10+i}\t|\tSpecies {i}\t|\t\t|\tscientific name\t|\n")
        with open(acc_p, "w") as f:
            f.write("accession\taccession.version\ttaxid\tgi\n")
            for i in range(GENOME_SEQS):
                f.write(f"seq{i}\tseq{i}.1\t{10+i}\t0\n")
    db = TaxDB(size=4096)
    db.read_nodes(nodes_p)
    db.read_names(names_p)
    db.read_acc2tid(acc_p)
    return db


def bench_pipeline(ref, fm, reads1, lens1, reads2, lens2) -> float:
    """End-to-end stages 0+2+3 (bbduk -> NT align -> SPIKE -> taxid
    merge -> reassign -> Kraken reports) on the same workload;
    returns reads/s."""
    from megapath.io.fastq import FastqRecord
    from megapath.pipeline.megapath import MegaPathPipeline, PipelineConfig

    decode = np.frombuffer(b"ACGT", dtype=np.uint8)
    qual = "I" * READ_LEN
    recs1 = [
        FastqRecord(f"rd{i:06d}", decode[reads1[i]].tobytes().decode(), qual)
        for i in range(N_PAIRS)
    ]
    recs2 = [
        FastqRecord(f"rd{i:06d}", decode[reads2[i]].tobytes().decode(), qual)
        for i in range(N_PAIRS)
    ]
    pipe = MegaPathPipeline(
        [(ref, fm)],
        _bench_taxdb(ref),
        config=PipelineConfig(
            read_len=READ_LEN, skip_human=True, device_seeding=True,
            # match the engine bench's read width so the pipeline reuses
            # the warm jit programs instead of compiling an L=128 set
            max_read_len=READ_LEN,
        ),
    )
    # steady state, same methodology as the align passes: the first
    # run pays this engine instance's device commit and compiles
    pipe.run_records(recs1, recs2)
    times = []
    for _ in range(2):
        t = time.time()
        res = pipe.run_records(recs1, recs2)
        times.append(time.time() - t)
    dt = min(times)
    log(
        f"pipeline: {dt:.2f}s ({2*N_PAIRS/dt:.0f} reads/s), "
        f"kept={res.n_after_preprocess}, spiked={res.spike_removed}, "
        f"report lines={len(res.report.splitlines())}"
    )
    return 2 * N_PAIRS / dt


def _run_passes(engine, reads1, lens1, reads2, lens2, tag, n=3):
    """Warmup + n timed passes; returns list of pass times.

    TWO warmup passes: pass 1 compiles the robust-plan programs and
    promotes the adaptive fast plan + exact-rescue subprograms; pass 2
    compiles those — timing from pass 3 is steady state."""
    log(f"{tag}: warmup (compiles)")
    for _ in range(2):
        t = time.time()
        engine.align_pairs(reads1, lens1, reads2, lens2)
        log(f"{tag}: warmup {time.time()-t:.1f}s")
    times = []
    for i in range(n):
        t = time.time()
        hits = engine.align_pairs(reads1, lens1, reads2, lens2)
        dt = time.time() - t
        times.append(dt)
        log(
            f"{tag}: pass {i}: {dt:.2f}s "
            f"({2*len(lens1)/dt:.0f} reads/s), hits={len(hits.read)}"
        )
    return times


def _stage_breakdown(engine, reads1, lens1, reads2, lens2):
    """Per-stage costs on one pass: seeding walk, SA locate, and the
    remainder (pair + deep DP + SE/rescue + host), each timed to
    ``block_until_ready`` of its outputs."""
    import jax

    from megapath.align.seeding_jax import (
        device_seed_pipeline, device_seed_pipeline_loc,
    )

    n = len(reads1)
    L = max(reads1.shape[1], reads2.shape[1])
    allr = np.zeros((2 * n, L), dtype=np.uint8)
    allr[:n, : reads1.shape[1]] = reads1
    allr[n:, : reads2.shape[1]] = reads2
    all_lens = np.concatenate([lens1, lens2]).astype(np.int32)
    Nb = ((2 * n + 4095) // 4096) * 4096 // 2
    if Nb * 2 != 2 * n:
        pad = Nb - n
        allr = np.concatenate(
            [allr, np.zeros((2 * pad, L), np.uint8)]
        )
        all_lens = np.concatenate([all_lens, np.zeros(2 * pad, np.int32)])
    mmp = engine.params.mmp
    max_seeds = int(min(16, max(4, L // 16 + 2)))
    limit = 3 * L + 64
    plan = engine._seed_seg_plan(2 * len(all_lens) // 2, L)
    cap = 2 * len(all_lens)
    lcap = 4 * len(all_lens)

    def timed(fn, reps=2):
        fn()
        best = 1e9
        for _ in range(reps):
            t = time.time()
            fn()
            best = min(best, time.time() - t)
        return best

    def walk_only():
        out = device_seed_pipeline(
            engine.dfm, allr, all_lens, mmp, max_seeds, limit, plan, cap,
            two_phase=engine._walk_two_phase,
        )
        jax.block_until_ready(out)

    def walk_loc():
        out = device_seed_pipeline_loc(
            engine.dfm, allr, all_lens, mmp, max_seeds, limit, plan, cap,
            lcap, two_phase=engine._walk_two_phase,
        )
        jax.block_until_ready(out)

    t_walk = timed(walk_only)
    t_loc = timed(walk_loc)

    def full():
        engine.align_pairs(reads1, lens1, reads2, lens2)

    t_full = timed(full, reps=1)
    return {
        "walk_s": round(t_walk, 3),
        "locate_s": round(max(t_loc - t_walk, 0.0), 3),
        "rest_s": round(max(t_full - t_loc, 0.0), 3),
        "full_s": round(t_full, 3),
    }


def _iqr_dispersion(times):
    """IQR/median of per-pass reads/s: the run-to-run spread."""
    rps = sorted(1.0 / t for t in times)  # monotone in reads/s
    med = statistics.median(rps)
    if len(rps) < 4 or med == 0:
        return 0.0
    q1 = statistics.median(rps[: len(rps) // 2])
    q3 = statistics.median(rps[(len(rps) + 1) // 2 :])
    return (q3 - q1) / med


def main() -> None:
    from megapath.align import AlignEngine, AlignParams
    from megapath.utils.compile_cache import use_compile_cache
    from megapath.utils.gpu import card_name_and_power, require_gpu

    import jax

    dev = require_gpu()[0]
    use_compile_cache()
    card = card_name_and_power()
    log(f"devices: {jax.devices()}; card: {card}")
    ref, fm, reads1, lens1, reads2, lens2 = build_workload()

    engine = AlignEngine(ref, fm, AlignParams(), device_seeding=True)
    times = _run_passes(engine, reads1, lens1, reads2, lens2, "toy", n=5)
    steady = statistics.median(times)
    reads_per_sec = 2 * N_PAIRS / steady
    best_rps = 2 * N_PAIRS / min(times)
    dispersion = _iqr_dispersion(times)

    # end-to-end pipeline throughput (BASELINE.md config 3 surface);
    # engine compiles are warm from the align passes above
    pipeline_rps = bench_pipeline(ref, fm, reads1, lens1, reads2, lens2)
    # release the toy phases' device arrays before the large shard
    # commits ~1 GB of tables: lingering buffers fragment HBM and
    # add run-to-run noise to the large passes
    import gc

    gc.collect()

    # ---- large shard (HBM-resident tables; the production regime) ----
    large_rps = 0.0
    large_disp = 0.0
    stages = {}
    skip_large = os.environ.get("BENCH_SKIP_LARGE", "")
    if not skip_large:
        from tools.build_bench_shard import build as build_big

        bref, bfm, br1, bl1, br2, bl2 = build_big()
        engine.evict()
        big_engine = AlignEngine(
            bref, bfm, AlignParams(), device_seeding=True
        )
        btimes = _run_passes(big_engine, br1, bl1, br2, bl2, "large", n=5)
        large_rps = 2 * len(bl1) / statistics.median(btimes)
        large_disp = _iqr_dispersion(btimes)
        stages = _stage_breakdown(big_engine, br1, bl1, br2, bl2)
        log(f"large-shard stages: {stages}")

    vs = 0.0
    bl_path = os.path.join(HERE, "bench_baseline.json")
    if os.path.exists(bl_path):
        with open(bl_path) as f:
            bl = json.load(f)
        denom = bl.get("soap4_reads_per_sec_alignment_only", 0)
        if denom:
            vs = reads_per_sec / denom

    print(
        json.dumps(
            {
                "metric": "align_reads_per_sec_per_chip",
                "value": round(reads_per_sec, 1),
                "unit": "reads/s",
                "vs_baseline": round(vs, 3),
                "best": round(best_rps, 1),
                "dispersion": round(dispersion, 3),
                "pipeline_reads_per_sec": round(pipeline_rps, 1),
                "large_shard_reads_per_sec": round(large_rps, 1),
                "large_shard_dispersion": round(large_disp, 3),
                "large_shard_stages": stages,
                "workload_hash": toy_hash(),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                    "card": card,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
