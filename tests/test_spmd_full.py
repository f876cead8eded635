"""Full-engine SPMD program parity on the 8-device virtual mesh.

The one-program path (parallel.spmd_full) must reproduce the host
engine's per-shard hit tables EXACTLY — multi SA-locate, cluster
filters, divide-gap pairing, conditional-right deep DP, single-end DP
(200 cap), mate rescue, unpaired output — and, fed through the shared
pipeline tail, the cascade fixture's byte-identical Kraken report
(the goldens come from the reference's sequential comment-chaining
cascade, tests/fixtures/make_cascade_fixtures.py).
"""

import pathlib

import numpy as np
import pytest

from megapath.align.params import AlignParams
from megapath.index.pack import COMPLEMENT

FIX = pathlib.Path(__file__).parent / "fixtures"
CAS = FIX / "cascade"


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[codes[::-1]].astype(np.uint8)


def _mesh(n_shards):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    rows = len(devs) // n_shards
    arr = np.array(devs[: rows * n_shards]).reshape(rows, n_shards)
    return Mesh(arr, axis_names=("data", "shard"))


def _hit_set(hits):
    return {
        (int(r), int(e), int(q), int(s), int(rw), int(a), int(b),
         int(st), bool(p))
        for r, e, q, s, rw, a, b, st, p in zip(
            hits.read, hits.end, hits.seq, hits.score, hits.raw_score,
            hits.start, hits.stop, hits.strand, hits.paired,
        )
    }


def _run_spmd(refs, fms, reads1, reads2, lens, params, L, caps=None,
              lens2=None):
    from megapath.parallel.spmd_full import (
        SpmdCaps,
        build_spmd_full_engine,
        pack_ref_rows,
        pad_ref_codes,
        pad_seq_offsets,
        spmd_hits_to_batch,
        stack_fms_exact,
    )

    sfm, meta = stack_fms_exact(fms)
    mesh = _mesh(len(fms))
    step = build_spmd_full_engine(
        mesh, meta, L, params=params, caps=caps or SpmdCaps()
    )
    ref_words = pack_ref_rows(pad_ref_codes([r.codes for r in refs]))
    seq_off = pad_seq_offsets([r.offsets for r in refs])
    out = step(sfm, ref_words, seq_off, reads1, reads2, lens,
               lens if lens2 is None else lens2)
    Bl = reads1.shape[0] // mesh.shape["data"]
    return spmd_hits_to_batch(out, Bl)


@pytest.fixture(scope="module")
def small_world():
    from megapath.index.fm import build_fm_index
    from megapath.index.pack import PackedReference, pack_fasta
    from megapath.io.fastq import FastqRecord
    from megapath.index.pack import decode_seq

    rng = np.random.default_rng(42)
    refs, fms, texts = [], [], []
    for s, sizes in enumerate([(4000, 3000, 2000), (3500, 2500)]):
        recs = []
        seqs = []
        for m, n in enumerate(sizes):
            c = rng.integers(0, 4, n).astype(np.uint8)
            seqs.append(c)
            recs.append(FastqRecord(f"s{s}m{m}", decode_seq(c), "", ""))
        ref = pack_fasta(recs)
        refs.append(ref)
        fms.append(build_fm_index(ref.codes, sa_interval=8, lut_k=8))
        texts.append(seqs)
    return refs, fms, texts


def _planted_reads(texts, B, L=80, insert=220, seed=5):
    rng = np.random.default_rng(seed)
    flat = [(s, c) for s, seqs in enumerate(texts) for c in seqs]
    reads1 = np.zeros((B, L), np.uint8)
    reads2 = np.zeros((B, L), np.uint8)
    for b in range(B):
        kind = b % 4
        if kind == 3:  # junk pair
            reads1[b] = rng.integers(0, 4, L)
            reads2[b] = rng.integers(0, 4, L)
            continue
        s, c = flat[b % len(flat)]
        p = int(rng.integers(0, len(c) - insert))
        r1 = c[p : p + L].copy()
        r2 = _revcomp(c[p + insert - L : p + insert]).copy()
        if kind == 1:  # mutated pair (a few mismatches)
            for arr in (r1, r2):
                for _ in range(3):
                    q = int(rng.integers(0, L))
                    arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
        if kind == 2:  # single-end only: trash one mate entirely
            r2 = rng.integers(0, 4, L).astype(np.uint8)
        reads1[b], reads2[b] = r1, r2
    lens = np.full(B, L, np.int32)
    return reads1, reads2, lens


def test_full_engine_hits_match_host_engine(small_world):
    """Per-shard hit tables from the one-program path == AlignEngine's,
    row for row (clean pairs, mutated pairs, SE+rescue, junk)."""
    from megapath.align import AlignEngine

    refs, fms, texts = small_world
    params = AlignParams()
    L, B = 80, 16
    reads1, reads2, lens = _planted_reads(texts, B, L=L)

    spmd_hits = _run_spmd(refs, fms, reads1, reads2, lens, params, L)

    for s, (ref, fm) in enumerate(zip(refs, fms)):
        engine = AlignEngine(ref, fm, params)
        want = engine.align_pairs(reads1, lens, reads2, lens)
        got = spmd_hits[s]
        ws, gs = _hit_set(want), _hit_set(got)
        assert gs == ws, (
            f"shard {s}: missing={sorted(ws - gs)[:5]} "
            f"extra={sorted(gs - ws)[:5]}"
        )


def test_pipeline_spmd_backend_cascade_byte_identical(mini_taxdb):
    """MegaPathPipeline(config.spmd=True) routes stage 2 through the
    one-program SPMD path and still reproduces the reference cascade's
    Kraken report byte for byte — the backend is selectable from the
    production driver, not just the bare program."""
    from megapath.index.fm import build_fm_index
    from megapath.index.pack import pack_fasta
    from megapath.io.fastq import read_fastx, trim_readno
    from megapath.pipeline import MegaPathPipeline, PipelineConfig

    def pack(p):
        ref = pack_fasta(list(read_fastx(p)))
        fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
        return ref, fm

    nt = [pack(CAS / "shard0.fa"), pack(CAS / "shard1.fa")]
    recs1 = list(read_fastx(CAS / "r1.fq"))
    recs2 = list(read_fastx(CAS / "r2.fq"))
    for r in recs1 + recs2:
        r.name = trim_readno(r.name)

    cfg = PipelineConfig(
        read_len=80, max_read_len=80, skip_preprocess=True,
        skip_human=True, spmd=True,
    )
    pipe = MegaPathPipeline(nt, mini_taxdb, config=cfg)
    res = pipe.run_records(recs1, recs2)

    golden = (CAS / "cascade.report").read_text()
    assert res.report == golden
    # the measured cross-shard merge payload is recorded per batch
    stats = pipe._spmd["payload"]
    assert stats is not None and stats["hit_rows"] > 0
    # grouped-payload bound: ~4 rows/pair/shard, not the ~40 internal
    # candidate rows (SCALING.md merge-payload section)
    assert stats["rows_per_pair_per_shard"] < 8


def test_full_engine_cascade_report_byte_identical(mini_taxdb):
    """SPMD hits + the shared pipeline tail reproduce the reference
    cascade's Kraken report byte for byte."""
    from megapath.index.fm import build_fm_index
    from megapath.index.pack import pack_fasta, pack_reads
    from megapath.io.fastq import read_fastx, trim_readno
    from megapath.pipeline import MegaPathPipeline, PipelineConfig

    def pack(p):
        ref = pack_fasta(list(read_fastx(p)))
        fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
        return ref, fm

    nt = [pack(CAS / "shard0.fa"), pack(CAS / "shard1.fa")]
    refs = [ref for ref, _ in nt]
    fms = [fm for _, fm in nt]
    recs1 = list(read_fastx(CAS / "r1.fq"))
    recs2 = list(read_fastx(CAS / "r2.fq"))
    for r in recs1 + recs2:
        r.name = trim_readno(r.name)
    n = len(recs1)
    L = 80
    reads1, lens1 = pack_reads([r.seq for r in recs1], L)
    reads2, lens2 = pack_reads([r.seq for r in recs2], L)

    # pad the batch to the data-axis grain; pad rows have len 0 and
    # emit nothing
    import jax

    D = len(jax.devices()) // 2
    B = ((n + D - 1) // D) * D
    if B != n:
        reads1 = np.concatenate([reads1, np.zeros((B - n, L), np.uint8)])
        reads2 = np.concatenate([reads2, np.zeros((B - n, L), np.uint8)])
        lens1 = np.concatenate([lens1, np.zeros(B - n, lens1.dtype)])
        lens2 = np.concatenate([lens2, np.zeros(B - n, lens2.dtype)])
    assert (lens1[:n] == L).all() and (lens2[:n] == L).all()

    params = AlignParams()
    per_shard = _run_spmd(refs, fms, reads1, reads2, lens1, params, L)
    # drop hits of the padding rows
    from megapath.align.engine import BatchHits

    per_shard = [
        BatchHits(*[getattr(h, f)[h.read < n] for f in (
            "read", "end", "seq", "score", "raw_score", "start", "stop",
            "strand", "paired")])
        for h in per_shard
    ]

    cfg = PipelineConfig(read_len=L, skip_preprocess=True, skip_human=True)
    pipe = MegaPathPipeline(nt, mini_taxdb, config=cfg)
    res = pipe._finish_records(recs1, recs2, per_shard, n)

    golden = (CAS / "cascade.report").read_text()
    assert res.report == golden

    # per-read LSAM.id records too (scores + hit accession sets)
    def load_golden_id(path):
        out = {}
        for line in open(path):
            c = line.rstrip("\n").split("\t")
            hits = (
                frozenset(h.split(",")[1] for h in c[5].split(";") if h)
                if c[5] != "*"
                else frozenset()
            )
            out[(c[0], c[1])] = (int(float(c[2])), hits)
        return out

    want = load_golden_id(CAS / "cascade.lsam.id")
    got = {}
    for rec in res.lsam_id:
        c = rec.to_line().split("\t")
        hits = (
            frozenset(h.split(",")[1] for h in c[5].split(";") if h)
            if c[5] != "*"
            else frozenset()
        )
        got[(c[0], c[1])] = (int(float(c[2])), hits)
    assert got == want


def test_spmd_full_wide_fixture_hit_parity():
    """The one-program path reproduces the host engine's hit tables on
    the WIDE fixture's adversarial read classes (indels, Ns, 151 bp
    truncation semantics, junk) — the same breadth the host parity
    suite runs against the reference soap4 golden."""
    from megapath.align import AlignEngine
    from megapath.index.fm import build_fm_index
    from megapath.index.pack import pack_fasta_file, pack_reads
    from megapath.parallel.spmd_full import SpmdCaps

    WIDE = FIX / "wide"
    from megapath.io.fastq import read_fastx

    ref = pack_fasta_file(WIDE / "genome.fa")
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
    params = AlignParams()
    L = 150  # soap4 -L 151 truncation semantics (QueryParser.cpp:188)

    r1 = list(read_fastx(WIDE / "r1.fq"))
    r2 = list(read_fastx(WIDE / "r2.fq"))
    # stride-sample: classes are block-ordered, every 4th pair keeps
    # all six classes while the CPU-mesh compile stays affordable
    idx = list(range(0, len(r1), 4))
    reads1, lens1 = pack_reads([r1[i].seq[:L] for i in idx], L)
    reads2, lens2 = pack_reads([r2[i].seq[:L] for i in idx], L)

    import jax

    D = len(jax.devices())  # one shard -> all devices on the data axis
    n = len(idx)
    B = ((n + D - 1) // D) * D
    if B != n:
        pad = B - n
        reads1 = np.concatenate([reads1, np.zeros((pad, L), np.uint8)])
        reads2 = np.concatenate([reads2, np.zeros((pad, L), np.uint8)])
        lens1 = np.concatenate([lens1, np.zeros(pad, lens1.dtype)])
        lens2 = np.concatenate([lens2, np.zeros(pad, lens2.dtype)])

    spmd_hits = _run_spmd(
        [ref], [fm], reads1, reads2, lens1, params, L,
        caps=SpmdCaps(pos_factor=64, cand_factor=16, se_factor=8,
                      hit_factor=12),
        lens2=lens2,
    )[0]
    keep = spmd_hits.read < n
    got = {
        (int(r), int(e), int(q), int(s), int(rw), int(a), int(b),
         int(st), bool(p))
        for k, (r, e, q, s, rw, a, b, st, p) in enumerate(zip(
            spmd_hits.read, spmd_hits.end, spmd_hits.seq,
            spmd_hits.score, spmd_hits.raw_score, spmd_hits.start,
            spmd_hits.stop, spmd_hits.strand, spmd_hits.paired,
        ))
        if keep[k]
    }

    engine = AlignEngine(ref, fm, params)
    want = _hit_set(engine.align_pairs(
        reads1[:n], lens1[:n], reads2[:n], lens2[:n]
    ))
    assert got == want, (
        f"missing={sorted(want - got)[:5]} extra={sorted(got - want)[:5]}"
    )


def test_spmd_full_hg_params_hit_parity(small_world):
    """hg-stage params (seed_min_length=22/reseed_len=23, the human
    filter's soap4.ini) through the one-program path == host engine."""
    from megapath.align import AlignEngine
    from megapath.pipeline.megapath import HG_PARAMS

    refs, fms, texts = small_world
    L, B = 80, 16
    reads1, reads2, lens = _planted_reads(texts, B, L=L, seed=9)

    spmd_hits = _run_spmd(refs, fms, reads1, reads2, lens, HG_PARAMS, L)
    for s, (ref, fm) in enumerate(zip(refs, fms)):
        engine = AlignEngine(ref, fm, HG_PARAMS)
        want = _hit_set(engine.align_pairs(reads1, lens, reads2, lens))
        got = _hit_set(spmd_hits[s])
        assert got == want, (
            f"shard {s}: missing={sorted(want - got)[:5]} "
            f"extra={sorted(got - want)[:5]}"
        )


def test_pipeline_spmd_ladder_handles_junk_heavy_batches(mini_taxdb):
    """A batch of reads that match NOTHING in the shards (the typical
    mid-cascade production composition) must come through the lean ->
    robust -> unstaged escalation ladder with results identical to the
    host engine — whichever ladder level ends up serving it."""
    import numpy as np

    from megapath.index.fm import build_fm_index
    from megapath.index.pack import pack_fasta
    from megapath.io.fastq import FastqRecord, read_fastx, trim_readno
    from megapath.pipeline import MegaPathPipeline, PipelineConfig

    def pack(p):
        ref = pack_fasta(list(read_fastx(p)))
        fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
        return ref, fm

    nt = [pack(CAS / "shard0.fa"), pack(CAS / "shard1.fa")]
    rng = np.random.default_rng(44)
    decode = np.frombuffer(b"ACGT", dtype=np.uint8)
    qual = "I" * 80
    recs1, recs2 = [], []
    for i in range(24):  # junk: random 80-mers, no shard matches them
        recs1.append(FastqRecord(
            f"junk{i}", decode[rng.integers(0, 4, 80)].tobytes().decode(),
            qual,
        ))
        recs2.append(FastqRecord(
            f"junk{i}", decode[rng.integers(0, 4, 80)].tobytes().decode(),
            qual,
        ))
    cfg = PipelineConfig(
        read_len=80, max_read_len=80, skip_preprocess=True,
        skip_human=True, spmd=True,
    )
    pipe = MegaPathPipeline(nt, mini_taxdb, config=cfg)
    res = pipe.run_records(recs1, recs2)
    # all junk -> every read unclassified; no crash, no silent hits
    assert "unclassified" in res.report
    for line in res.report.splitlines():
        cols = line.split("\t")
        if cols[3] == "S":
            assert int(cols[1]) == 0, line
