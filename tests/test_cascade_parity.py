"""Multi-shard cascade parity vs the reference pipeline.

The golden files were produced by running the REAL reference cascade
(tests/fixtures/make_cascade_fixtures.py): soap4 on shard0 with -nc,
its cfq stdout deinterleaved and re-aligned by soap4 on shard1 with
hit comments carried (runMegaPath.sh:191-208), then fastq2lsam |
taxLookupAcc | genKrakenReport. Our pipeline runs both shards
CONCURRENTLY and merges hit arrays — this test proves the associative
array merge reproduces the reference's sequential comment-chaining
byte for byte, including score pass-through for hits whose accession
has no taxid mapping (AF304460 is deliberately absent from
acc2tid.map).
"""

import pathlib

import pytest

FIX = pathlib.Path(__file__).parent / "fixtures"
CAS = FIX / "cascade"


@pytest.fixture(scope="module")
def cascade_result(mini_taxdb):
    from megapath.index.fm import build_fm_index
    from megapath.index.pack import pack_fasta
    from megapath.io.fastq import read_fastx, trim_readno
    from megapath.pipeline import MegaPathPipeline, PipelineConfig

    def pack(p):
        ref = pack_fasta(list(read_fastx(p)))
        fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
        return ref, fm

    nt = [pack(CAS / "shard0.fa"), pack(CAS / "shard1.fa")]
    cfg = PipelineConfig(read_len=80, skip_preprocess=True, skip_human=True)
    pipe = MegaPathPipeline(nt, mini_taxdb, config=cfg)
    recs1 = list(read_fastx(CAS / "r1.fq"))
    recs2 = list(read_fastx(CAS / "r2.fq"))
    for r in recs1 + recs2:
        r.name = trim_readno(r.name)
    return pipe.run_records(recs1, recs2)


def _load_id(path):
    out = {}
    for line in open(path):
        c = line.rstrip("\n").split("\t")
        hits = (
            frozenset(h.split(",")[1] for h in c[5].split(";"))
            if c[5] != "*"
            else frozenset()
        )
        out[(c[0], c[1])] = (int(float(c[2])), hits)
    return out


def test_cascade_report_byte_identical(cascade_result):
    golden = (CAS / "cascade.report").read_text()
    assert cascade_result.report == golden


def test_cascade_per_read_records(cascade_result):
    golden = _load_id(CAS / "cascade.lsam.id")
    ours = {}
    for rec in cascade_result.lsam_id:
        line = rec.to_line()
        c = line.split("\t")
        hits = (
            frozenset(h.split(",")[1] for h in c[5].split(";"))
            if c[5] != "*"
            else frozenset()
        )
        ours[(c[0], c[1])] = (int(float(c[2])), hits)
    assert set(golden) == set(ours)
    mismatches = [k for k in golden if golden[k] != ours[k]]
    assert mismatches == []


@pytest.fixture(scope="module")
def dist_cascade_result(mini_taxdb):
    """Same cascade, but each shard engine committed to its own device
    of the 8-device virtual mesh, device seeding on, shard alignments
    dispatched concurrently (parallel placement)."""
    import jax

    from megapath.index.fm import build_fm_index
    from megapath.index.pack import pack_fasta
    from megapath.io.fastq import read_fastx, trim_readno
    from megapath.pipeline import MegaPathPipeline, PipelineConfig

    def pack(p):
        ref = pack_fasta(list(read_fastx(p)))
        fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
        return ref, fm

    nt = [pack(CAS / "shard0.fa"), pack(CAS / "shard1.fa")]
    cfg = PipelineConfig(
        read_len=80, skip_preprocess=True, skip_human=True,
        device_seeding=True,
    )
    devs = jax.devices()
    assert len(devs) >= 2, "conftest must expose the virtual CPU mesh"
    pipe = MegaPathPipeline(nt, mini_taxdb, config=cfg, devices=devs)
    # verify the placement is real: each shard's FM lives on its device
    assert pipe.nt_engines[0].dfm.fused_rows.devices() != \
        pipe.nt_engines[1].dfm.fused_rows.devices()
    recs1 = list(read_fastx(CAS / "r1.fq"))
    recs2 = list(read_fastx(CAS / "r2.fq"))
    for r in recs1 + recs2:
        r.name = trim_readno(r.name)
    return pipe.run_records(recs1, recs2)


def test_distributed_cascade_report_byte_identical(dist_cascade_result):
    golden = (CAS / "cascade.report").read_text()
    assert dist_cascade_result.report == golden


def test_distributed_cascade_per_read_records(dist_cascade_result):
    golden = _load_id(CAS / "cascade.lsam.id")
    ours = {}
    for rec in dist_cascade_result.lsam_id:
        line = rec.to_line()
        c = line.split("\t")
        hits = (
            frozenset(h.split(",")[1] for h in c[5].split(";"))
            if c[5] != "*"
            else frozenset()
        )
        ours[(c[0], c[1])] = (int(float(c[2])), hits)
    assert set(golden) == set(ours)
    mismatches = [k for k in golden if golden[k] != ours[k]]
    assert mismatches == []


def test_distributed_matches_sequential(dist_cascade_result, cascade_result):
    assert dist_cascade_result.report == cascade_result.report
    assert dist_cascade_result.ra_report == cascade_result.ra_report
