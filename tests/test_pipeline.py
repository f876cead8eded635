"""End-to-end pipeline tests on a synthetic world with real taxonomy."""

import numpy as np
import pytest

from megapath.index.fm import build_fm_index
from megapath.index.pack import COMPLEMENT, decode_seq, pack_fasta
from megapath.io.fastq import FastqRecord
from megapath.pipeline import MegaPathPipeline, PipelineConfig


@pytest.fixture(scope="module")
def world(mini_taxdb):
    """Two NT shards whose sequences are accessions of the mini taxdb,
    plus a human shard."""
    rng = np.random.default_rng(123)

    def mkseq(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    # shard 0: E. coli + Salmonella; shard 1: the viruses
    s0 = {
        "NC_000913.1 Escherichia coli K-12": mkseq(8000),
        "NC_003197.1 Salmonella enterica": mkseq(7000),
    }
    s1 = {
        "NC_045512.1 SARS-CoV-2": mkseq(5000),
        "NC_002645.1 HCoV-229E": mkseq(4000),
    }
    hg = {"NC_000001.1 Homo sapiens chr1": mkseq(9000)}

    def pack(d):
        ref = pack_fasta(
            [FastqRecord(k.split()[0], decode_seq(v), "", " ".join(k.split()[1:]))
             for k, v in d.items()]
        )
        fm = build_fm_index(ref.codes, sa_interval=4, lut_k=6)
        return ref, fm

    shard0 = pack(s0)
    shard1 = pack(s1)
    hg_shard = pack(hg)
    seqs = {**s0, **s1, **hg}
    return shard0, shard1, hg_shard, seqs, mini_taxdb


def _pairs_from(seqs, key, rng, n, read_len=80, insert=300, prefix="rd"):
    codes = seqs[key]
    qual = "I" * read_len
    r1, r2 = [], []
    for i in range(n):
        p = int(rng.integers(0, len(codes) - insert))
        a = codes[p : p + read_len]
        seg = codes[p + insert - read_len : p + insert]
        b = COMPLEMENT[seg[::-1]]
        name = f"{prefix}{key.split()[0]}_{i}"
        r1.append(FastqRecord(name, decode_seq(a), qual))
        r2.append(FastqRecord(name, decode_seq(b), qual))
    return r1, r2


def test_pipeline_end_to_end(world):
    shard0, shard1, hg_shard, seqs, db = world
    rng = np.random.default_rng(5)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True)
    pipe = MegaPathPipeline(
        [shard0, shard1], db, hg_shard=hg_shard, config=cfg
    )

    r1, r2 = [], []
    for key, n in [
        ("NC_000913.1 Escherichia coli K-12", 10),
        ("NC_003197.1 Salmonella enterica", 6),
        ("NC_045512.1 SARS-CoV-2", 4),
        ("NC_000001.1 Homo sapiens chr1", 5),  # human: filtered out
    ]:
        a, b = _pairs_from(seqs, key, rng, n)
        r1 += a
        r2 += b
    res = pipe.run_records(r1, r2)

    assert res.n_after_preprocess == 25
    assert res.n_after_human == 20  # 5 human pairs dropped

    # reports: species counts (paired reads => 2 lines per pair)
    rep = res.report
    lines = {tuple(l.split("\t")) for l in rep.splitlines()[1:]}
    by_tid = {int(t[4]): (int(t[1]), int(t[2])) for t in lines}
    assert by_tid[562] == (20, 20)  # E. coli clade/stay
    assert by_tid[28901] == (12, 12)
    assert by_tid[694009] == (8, 8)
    assert 9606 not in by_tid
    assert by_tid[0] == (0, 0)  # nothing unclassified


def test_pipeline_report_scores_are_paired_sums(world):
    shard0, shard1, hg_shard, seqs, db = world
    rng = np.random.default_rng(6)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True, skip_human=True)
    pipe = MegaPathPipeline([shard0, shard1], db, config=cfg)
    r1, r2 = _pairs_from(seqs, "NC_000913.1 Escherichia coli K-12", rng, 3)
    res = pipe.run_records(r1, r2)
    for rec in res.lsam_id:
        assert rec.score == 160  # 2 x 80 paired sum
        assert [t for _, t in rec.hits] == ["562"]


def test_pipeline_preprocess_drops_low_complexity(world):
    shard0, shard1, hg_shard, seqs, db = world
    rng = np.random.default_rng(7)
    cfg = PipelineConfig(read_len=80, min_len=50, skip_human=True)
    pipe = MegaPathPipeline([shard0, shard1], db, config=cfg)
    r1, r2 = _pairs_from(seqs, "NC_003197.1 Salmonella enterica", rng, 3, read_len=80)
    # one low-complexity pair
    r1.append(FastqRecord("lowc", "AT" * 40, "I" * 80))
    r2.append(FastqRecord("lowc", "TA" * 40, "I" * 80))
    res = pipe.run_records(r1, r2)
    assert res.n_after_preprocess == 3


def test_pipeline_reassign_changes_report(world):
    """A dominant taxon with many unique reads explains a co-occurring
    one; the ra report drops the explained taxon."""
    shard0, shard1, hg_shard, seqs, db = world
    rng = np.random.default_rng(8)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True, skip_human=True)
    pipe = MegaPathPipeline([shard0, shard1], db, config=cfg)

    # make E.coli and Salmonella share a 400bp block so reads from it
    # hit both species (co-occurrence); plus many unique E.coli reads
    ec = seqs["NC_000913.1 Escherichia coli K-12"]
    r1, r2 = _pairs_from(seqs, "NC_000913.1 Escherichia coli K-12", rng, 30)
    res = pipe.run_records(r1, r2)
    assert res.report  # smoke: reassign ran; no explains expected here
    assert res.ra_report.splitlines()[0].startswith("perc")


def _write_fastq(recs, path):
    with open(path, "w") as f:
        for r in recs:
            f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")


def test_streaming_run_files_matches_run_records(world, tmp_path):
    """run_files streams batches (SOAP4.cpp:445 double-buffer shape)
    and must reproduce the in-memory path's reports and LSAM bytes,
    including across a batch boundary."""
    shard0, shard1, hg_shard, seqs, db = world
    rng = np.random.default_rng(6)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True, batch_size=7)
    pipe = MegaPathPipeline([shard0, shard1], db, hg_shard=hg_shard, config=cfg)

    r1, r2 = [], []
    for key, n in [
        ("NC_000913.1 Escherichia coli K-12", 9),
        ("NC_045512.1 SARS-CoV-2", 5),
        ("NC_000001.1 Homo sapiens chr1", 3),
    ]:
        a, b = _pairs_from(seqs, key, rng, n)
        r1 += a
        r2 += b
    want = pipe.run_records(r1, r2)

    p1, p2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    _write_fastq(r1, p1)
    _write_fastq(r2, p2)
    got = pipe.run_files(str(p1), str(p2), str(tmp_path / "mp"))

    assert got.report == want.report
    assert got.ra_report == want.ra_report
    assert got.n_after_human == want.n_after_human
    # on-disk LSAM matches the in-memory records byte for byte
    lines = (tmp_path / "mp.nt.lsam.id").read_text().splitlines()
    assert lines == [rec.to_line() for rec in want.lsam_id]
    # per-stage markers exist and a rerun resumes from the align state
    assert (tmp_path / "mp.align.done").exists()
    assert (tmp_path / "mp.done").exists()
    again = pipe.run_files(str(p1), str(p2), str(tmp_path / "mp"))
    assert again.report == want.report


def test_ribosome_stage_filters_pairs(world):
    """-S stage: pairs matching the 16S index at >= 0.95 * pair length
    (pair-required -P scoring) are removed before NT alignment
    (runMegaPath.sh:155-169)."""
    shard0, shard1, hg_shard, seqs, db = world
    rng = np.random.default_rng(7)
    ribo_seq = rng.integers(0, 4, 3000).astype(np.uint8)
    ref = pack_fasta([FastqRecord("SILVA_1", decode_seq(ribo_seq), "", "")])
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=6)

    cfg = PipelineConfig(read_len=80, skip_preprocess=True, skip_human=True)
    pipe = MegaPathPipeline(
        [shard0, shard1], db, config=cfg, ribo_shard=(ref, fm)
    )

    # 4 rRNA pairs (exact -> summed score 160 >= 0.95*160) + 5 real
    qual = "I" * 80
    rr1, rr2 = [], []
    for i in range(4):
        p = int(rng.integers(0, len(ribo_seq) - 300))
        a = ribo_seq[p : p + 80]
        seg = ribo_seq[p + 220 : p + 300]
        b = COMPLEMENT[seg[::-1]]
        rr1.append(FastqRecord(f"ribo{i}", decode_seq(a), qual))
        rr2.append(FastqRecord(f"ribo{i}", decode_seq(b), qual))
    e1, e2 = _pairs_from(seqs, "NC_000913.1 Escherichia coli K-12", rng, 5)
    res = pipe.run_records(rr1 + e1, rr2 + e2)
    assert res.n_after_ribo == 5
    # ribo reads gone; E. coli still reported
    assert "Escherichia" in res.report
    names = {r.name for r in res.lsam_id}
    assert not any(n.startswith("ribo") for n in names)


def test_assembly_stage_writes_outputs(world, tmp_path):
    """-A wiring: run_files(assembly=True) extracts viral+unmapped
    pairs and writes contigs + r2c LSAM (runMegaPath.sh:267-330)."""
    shard0, shard1, hg_shard, seqs, db = world
    rng = np.random.default_rng(8)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True, skip_human=True)
    pipe = MegaPathPipeline([shard0, shard1], db, config=cfg)

    # dense tiling of a SARS-CoV-2 region so the unitig fallback can
    # assemble a contig from the (viral) extracted reads
    codes = seqs["NC_045512.1 SARS-CoV-2"]
    qual = "I" * 80
    r1, r2 = [], []
    for i, p in enumerate(range(1000, 1400, 10)):
        a = codes[p : p + 80]
        seg = codes[p + 220 : p + 300]
        b = COMPLEMENT[seg[::-1]]
        r1.append(FastqRecord(f"v{i}", decode_seq(a), qual))
        r2.append(FastqRecord(f"v{i}", decode_seq(b), qual))
    p1, p2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    _write_fastq(r1, p1)
    _write_fastq(r2, p2)
    pipe.run_files(str(p1), str(p2), str(tmp_path / "asm"), assembly=True)
    assert (tmp_path / "asm.assembly.done").exists()
    contigs = (tmp_path / "asm.contigs.fa").read_text()
    assert contigs.startswith(">ctg0")
    assert len(contigs.splitlines()[1]) >= 100


def test_run_files_aborts_on_empty_stage(world, tmp_path):
    """Failure detection (runMegaPath.sh:143-146): if every read dies
    in a stage, the run aborts loudly instead of writing an empty
    report."""
    import pytest

    from megapath.pipeline.megapath import PipelineAbort

    shard0, shard1, hg_shard, seqs, db = world
    rng = np.random.default_rng(66)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True)
    pipe = MegaPathPipeline([shard0, shard1], db, hg_shard=hg_shard, config=cfg)
    # all-human input: the host filter removes everything
    r1, r2 = _pairs_from(seqs, "NC_000001.1 Homo sapiens chr1", rng, 6)
    p1, p2 = tmp_path / "h1.fq", tmp_path / "h2.fq"
    _write_fastq(r1, p1)
    _write_fastq(r2, p2)
    with pytest.raises(PipelineAbort, match="host filtering"):
        pipe.run_files(str(p1), str(p2), str(tmp_path / "ab"))


def test_run_files_resumes_from_batch_journal(world, tmp_path):
    """Per-batch resume: a run killed at batch k replays the journal
    and realigns only batches >= k (finer than the reference's
    stage-level .done gates, runMegaPath.sh:109-246)."""
    import pytest

    shard0, shard1, hg_shard, seqs, db = world
    rng = np.random.default_rng(9)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True, batch_size=5)
    pipe = MegaPathPipeline([shard0, shard1], db, hg_shard=hg_shard, config=cfg)

    r1, r2 = [], []
    for key, n in [
        ("NC_000913.1 Escherichia coli K-12", 8),
        ("NC_045512.1 SARS-CoV-2", 9),
    ]:
        a, b = _pairs_from(seqs, key, rng, n)
        r1 += a
        r2 += b
    want = pipe.run_records(r1, r2)

    p1, p2 = tmp_path / "j1.fq", tmp_path / "j2.fq"
    _write_fastq(r1, p1)
    _write_fastq(r2, p2)

    # crash the run inside batch 2 (after 2 journaled batches)
    orig = pipe._align_shards
    calls = {"n": 0}

    def bomb(*a, **k):
        if calls["n"] == 2:
            raise RuntimeError("synthetic crash at batch 2")
        calls["n"] += 1
        return orig(*a, **k)

    pipe._align_shards = bomb
    with pytest.raises(RuntimeError, match="synthetic crash"):
        pipe.run_files(str(p1), str(p2), str(tmp_path / "jr"))
    bdir = tmp_path / "jr.align_batches"
    assert sorted(p.name for p in bdir.iterdir()) == [
        "batch000000.npz", "batch000001.npz"
    ]
    assert not (tmp_path / "jr.align.done").exists()

    # resume: only the remaining batches align (2 more of 4 total)
    calls2 = {"n": 0}

    def count(*a, **k):
        calls2["n"] += 1
        return orig(*a, **k)

    pipe._align_shards = count
    got = pipe.run_files(str(p1), str(p2), str(tmp_path / "jr"))
    assert calls2["n"] == 2  # batches 2 and 3 only
    assert got.report == want.report
    assert got.ra_report == want.ra_report
    lines = (tmp_path / "jr.nt.lsam.id").read_text().splitlines()
    assert lines == [rec.to_line() for rec in want.lsam_id]
    assert not bdir.exists()  # journal dropped once the stage gate lands


def test_run_files_bam_output(world, tmp_path):
    """--bam wiring: run_files(config.bam=True) writes per-shard BAMs
    plus the merged/sorted PREFIX.nt.bam (runMegaPath.sh:199-216).
    Records round-trip io.bam and CIGARs come from the real batched
    traceback (full-match reads -> full-length M runs covering the
    read; coordinate-sorted within the merged file)."""
    import re

    from megapath.io.bam import read_bam

    shard0, shard1, hg_shard, seqs, db = world
    rng = np.random.default_rng(17)
    cfg = PipelineConfig(
        read_len=80, skip_preprocess=True, batch_size=6, bam=True
    )
    pipe = MegaPathPipeline([shard0, shard1], db, config=cfg)

    r1, r2 = [], []
    for key, n in [
        ("NC_000913.1 Escherichia coli K-12", 7),
        ("NC_045512.1 SARS-CoV-2", 6),
    ]:
        a, b = _pairs_from(seqs, key, rng, n)
        r1 += a
        r2 += b
    p1, p2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    _write_fastq(r1, p1)
    _write_fastq(r2, p2)
    pipe.run_files(str(p1), str(p2), str(tmp_path / "bm"))

    for si in range(2):
        assert (tmp_path / f"bm.nt.bam.{si}").exists()
    with open(tmp_path / "bm.nt.bam", "rb") as f:
        header, lines = read_bam(f)
    assert "@SQ\tSN:NC_000913.1" in header and "@SQ\tSN:NC_045512.1" in header
    assert len(lines) >= 2 * len(r1)  # every planted pair aligned, 2 ends
    order = {}
    for l in header.splitlines():
        if l.startswith("@SQ"):
            d = dict(x.split(":", 1) for x in l.split("\t")[1:])
            order[d["SN"]] = len(order)
    prev = (-1, -1)
    for line in lines:
        c = line.split("\t")
        rid, pos = order[c[2]], int(c[3])
        assert (rid, pos) >= prev, "merged BAM must be coordinate-sorted"
        prev = (rid, pos)
        # planted exact reads: CIGAR ops must consume the read length
        consumed = sum(
            int(num) for num, op in re.findall(r"(\d+)([MIS])", c[5])
        )
        assert consumed == 80, f"CIGAR {c[5]} does not cover the read"
        assert int(c[3]) >= 1


def test_run_files_spmd_backend_with_bam(world, tmp_path):
    """The two round-4 driver features compose: run_files with the
    one-program SPMD backend (config.spmd) AND BAM output (config.bam)
    produces the same reports as the host path plus a merged BAM whose
    records cover the aligned reads."""
    from megapath.io.bam import read_bam

    shard0, shard1, hg_shard, seqs, db = world
    rng = np.random.default_rng(23)
    r1, r2 = [], []
    for key, n in [
        ("NC_000913.1 Escherichia coli K-12", 6),
        ("NC_045512.1 SARS-CoV-2", 5),
    ]:
        a, b = _pairs_from(seqs, key, rng, n)
        r1 += a
        r2 += b
    p1, p2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    _write_fastq(r1, p1)
    _write_fastq(r2, p2)

    cfg_host = PipelineConfig(read_len=80, max_read_len=80,
                              skip_preprocess=True, batch_size=6)
    host = MegaPathPipeline([shard0, shard1], db, config=cfg_host)
    want = host.run_files(str(p1), str(p2), str(tmp_path / "host"))

    cfg = PipelineConfig(read_len=80, max_read_len=80,
                         skip_preprocess=True, batch_size=6,
                         spmd=True, bam=True)
    pipe = MegaPathPipeline([shard0, shard1], db, config=cfg)
    got = pipe.run_files(str(p1), str(p2), str(tmp_path / "sp"))

    assert got.report == want.report
    assert got.ra_report == want.ra_report
    assert (tmp_path / "sp.nt.lsam.id").read_text() == (
        tmp_path / "host.nt.lsam.id"
    ).read_text()
    with open(tmp_path / "sp.nt.bam", "rb") as f:
        header, lines = read_bam(f)
    assert len(lines) >= 2 * len(r1)
    assert pipe._spmd["payload"]["hit_rows"] > 0


def test_e2e_sensitivity_fdr_gate():
    """Tolerance gate on the end-to-end sensitivity/FDR evaluation:
    a scaled-down version of tools/e2e_eval.py's simulated community
    (uneven abundance, read errors, decoy genomes). The full-size run
    against the reference pipeline is recorded in EVAL.md (both
    pipelines: sensitivity 1.0, FDR 0.0, byte-identical reports); this
    gate holds our pipeline to that measured operating point."""
    import numpy as np

    from megapath.index.fm import build_fm_index
    from megapath.index.pack import pack_fasta
    from megapath.io.fastq import FastqRecord
    from megapath.pipeline.megapath import (
        MegaPathPipeline,
        PipelineConfig,
    )
    from megapath.taxonomy.taxdb import TaxDB

    rng = np.random.default_rng(67)
    decode = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_species, n_decoys, glen, L, ins = 10, 2, 60_000, 100, 320
    genomes = [
        rng.integers(0, 4, glen).astype(np.uint8)
        for _ in range(n_species + n_decoys)
    ]
    ref = pack_fasta(
        [
            FastqRecord(f"genome{i}", decode[g].tobytes().decode(), "")
            for i, g in enumerate(genomes)
        ]
    )
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)

    import io as _io
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        with open(f"{d}/nodes.dmp", "w") as f:
            f.write("1\t|\t1\t|\tno rank\t|\t\n2\t|\t1\t|\tsuperkingdom\t|\t\n")
            for i in range(n_species + n_decoys):
                f.write(f"{10+i}\t|\t2\t|\tspecies\t|\t\n")
        with open(f"{d}/names.dmp", "w") as f:
            f.write(
                "1\t|\troot\t|\t\t|\tscientific name\t|\n"
                "2\t|\tBacteria\t|\t\t|\tscientific name\t|\n"
            )
            for i in range(n_species + n_decoys):
                f.write(f"{10+i}\t|\tSpecies {i}\t|\t\t|\tscientific name\t|\n")
        with open(f"{d}/acc2tid.map", "w") as f:
            f.write("accession\taccession.version\ttaxid\tgi\n")
            for i in range(n_species + n_decoys):
                f.write(f"genome{i}\tgenome{i}.1\t{10+i}\t0\n")
        db = TaxDB(size=4096)
        db.read_nodes(f"{d}/nodes.dmp")
        db.read_names(f"{d}/names.dmp")
        db.read_acc2tid(f"{d}/acc2tid.map")

    w = np.logspace(0, -2.5, n_species)
    w /= w.sum()
    counts = rng.multinomial(600, w)
    comp = np.array([3, 2, 1, 0], np.uint8)
    recs1, recs2, truth = [], [], {}
    i = 0
    for sp in range(n_species):
        g = genomes[sp]
        for _ in range(counts[sp]):
            p = int(rng.integers(0, glen - ins))
            r1 = g[p : p + L].copy()
            r2 = comp[g[p + ins - L : p + ins][::-1]].copy()
            for arr in (r1, r2):
                for _ in range(int(rng.binomial(L, 0.005))):
                    q = int(rng.integers(0, L))
                    arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
            name = f"rd{i:05d}"
            truth[name] = 10 + sp
            recs1.append(
                FastqRecord(name, decode[r1].tobytes().decode(), "I" * L)
            )
            recs2.append(
                FastqRecord(name, decode[r2].tobytes().decode(), "I" * L)
            )
            i += 1

    pipe = MegaPathPipeline(
        [(ref, fm)], db,
        config=PipelineConfig(
            read_len=L, skip_human=True, device_seeding=True, max_read_len=L
        ),
    )
    res = pipe.run_records(recs1, recs2)

    tp = fp = fn = 0
    for rec in res.lsam_id:
        t = truth.get(rec.name)
        if t is None:
            continue
        if rec.score < 40 or not rec.hits:
            fn += 1
            continue
        tids = {int(float(x)) for _, x in rec.hits}
        if t in tids:
            tp += 1
            fp += len(tids) - 1
        else:
            fn += 1
            fp += len(tids)
    sens = tp / max(tp + fn, 1)
    fdr = fp / max(tp + fp, 1)
    assert sens >= 0.99, (tp, fn)
    assert fdr <= 0.01, (tp, fp)
    # every sampled species with >= 5 pairs must appear in the report
    want_sp = {10 + s for s in range(n_species) if counts[s] >= 5}
    got_sp = set()
    for line in res.ra_report.splitlines():
        c = line.split("\t")
        if len(c) >= 6 and c[3] == "S" and int(c[1]) > 0:
            got_sp.add(int(c[4]))
    assert want_sp <= got_sp, want_sp - got_sp
    assert not (got_sp - {10 + s for s in range(n_species)}), "false species"
