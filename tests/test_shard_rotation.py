"""Shard staging beyond HBM: more index shards than devices.

The production NT build is ~125 shards at the 2 Gbp cap (the
reference README's 250 GB NT, splitFasta.pl:19), more than the device
memory of a few cards holds, so the pipeline must rotate shards through
the devices (host-RAM staging) rather than committing all of them up
front. These tests run 4 shards on 2 virtual devices and
assert (a) at most n_devices shards are ever device-resident, and
(b) the waved run's reports match the all-resident run byte for byte.
"""

import numpy as np
import pytest

from megapath.index.fm import build_fm_index
from megapath.index.pack import COMPLEMENT, decode_seq, pack_fasta
from megapath.io.fastq import FastqRecord
from megapath.pipeline import MegaPathPipeline, PipelineConfig


@pytest.fixture(scope="module")
def world4():
    rng = np.random.default_rng(77)
    shards, texts = [], []
    for s in range(4):
        c = rng.integers(0, 4, 4000).astype(np.uint8)
        ref = pack_fasta(
            [FastqRecord(f"seq{s}.1 sp{s}", decode_seq(c), "", "")]
        )
        shards.append((ref, build_fm_index(ref.codes, sa_interval=8, lut_k=8)))
        texts.append(c)
    return shards, texts


def _taxdb_for(n):
    from megapath.taxonomy.taxdb import TaxDB
    import io, tempfile, os

    d = tempfile.mkdtemp()
    with open(os.path.join(d, "nodes.dmp"), "w") as f:
        f.write("1\t|\t1\t|\tno rank\t|\t\n")
        f.write("2\t|\t1\t|\tsuperkingdom\t|\t\n")
        for i in range(n):
            f.write(f"{10+i}\t|\t2\t|\tspecies\t|\t\n")
    with open(os.path.join(d, "names.dmp"), "w") as f:
        f.write("1\t|\troot\t|\t\t|\tscientific name\t|\n")
        f.write("2\t|\tBacteria\t|\t\t|\tscientific name\t|\n")
        for i in range(n):
            f.write(f"{10+i}\t|\tSpecies {i}\t|\t\t|\tscientific name\t|\n")
    with open(os.path.join(d, "acc.map"), "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        for i in range(n):
            f.write(f"seq{i}\tseq{i}.1\t{10+i}\t0\n")
    db = TaxDB(size=4096)
    db.read_nodes(os.path.join(d, "nodes.dmp"))
    db.read_names(os.path.join(d, "names.dmp"))
    db.read_acc2tid(os.path.join(d, "acc.map"))
    return db


def _reads(texts, n_per, L=80, insert=200, seed=3):
    rng = np.random.default_rng(seed)
    qual = "I" * L
    r1, r2 = [], []
    for s, c in enumerate(texts):
        for i in range(n_per):
            p = int(rng.integers(0, len(c) - insert))
            a = c[p : p + L]
            b = COMPLEMENT[c[p + insert - L : p + insert][::-1]]
            r1.append(FastqRecord(f"s{s}r{i}", decode_seq(a), qual))
            r2.append(FastqRecord(f"s{s}r{i}", decode_seq(b), qual))
    return r1, r2


def test_wave_rotation_bounds_residency_and_matches(world4):
    import jax

    shards, texts = world4
    db = _taxdb_for(4)
    cfg = PipelineConfig(read_len=80, skip_preprocess=True, skip_human=True,
                         device_seeding=True)
    r1, r2 = _reads(texts, 5)

    # reference result: all shards resident (no devices argument)
    want = MegaPathPipeline(shards, db, config=cfg).run_records(r1, r2)

    devs = jax.devices()[:2]
    pipe = MegaPathPipeline(shards, db, config=cfg, devices=devs)
    assert pipe._wave_shards
    # lazy: nothing committed at construction
    assert not any(e.committed for e in pipe.nt_engines)

    # track peak simultaneous residency across the run
    peak = {"v": 0}
    orig_commit = pipe.nt_engines[0].__class__.commit

    def counting_commit(self):
        orig_commit(self)
        cur = sum(e.committed for e in pipe.nt_engines)
        peak["v"] = max(peak["v"], cur)

    for e in pipe.nt_engines:
        e.commit = counting_commit.__get__(e)

    got = pipe.run_records(r1, r2)
    assert peak["v"] <= len(devs), (
        f"{peak['v']} shards resident at once with {len(devs)} devices"
    )
    assert not any(e.committed for e in pipe.nt_engines)  # evicted after
    assert got.report == want.report
    assert got.ra_report == want.ra_report
    assert [r.to_line() for r in got.lsam_id] == [
        r.to_line() for r in want.lsam_id
    ]
