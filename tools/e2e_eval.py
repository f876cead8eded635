#!/usr/bin/env python
"""End-to-end sensitivity/FDR evaluation vs the reference pipeline on
a simulated multi-species community.

Mirrors the reference's de facto integration test
(/root/reference/calcAccuracy.pl:11-33 scores a 22-virus simulated
FASTQ whose read names encode the source genome): simulate a
22-species community with uneven abundance (4 orders of magnitude) +
sequencing errors against a 25-genome database (3 decoys), run BOTH
pipelines end to end —

  reference: 2bwt-builder + soap4 + fastq2lsam | taxLookupAcc |
             reassign | genKrakenReport  (/tmp/refbuild binaries)
  ours:      MegaPathPipeline (device seeding, exact-rescue default)

— and score read-level sensitivity/FDR (species rank) plus
report-level species presence for each. Prints one JSON line and a
markdown table (written to EVAL.md with --write-md).

Cached under bench_cache/e2e_<hash>/ like the parity audit.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CACHE = os.path.join(HERE, "bench_cache")

from tools.parity_audit import REFBUILD, SOAP4_FLAGS, ensure_refbuild, sh  # noqa: E402

N_SPECIES = 22
N_DECOYS = 3
GENOME_LEN = 400_000
N_PAIRS = 50_000
READ_LEN = 100
INSERT = 320
ERR = 0.005  # per-base error rate
SEED = 67


def log(m):
    print(f"[e2e] {m}", file=sys.stderr, flush=True)


def cfg_hash() -> str:
    key = json.dumps(
        [N_SPECIES, N_DECOYS, GENOME_LEN, N_PAIRS, READ_LEN, INSERT, ERR,
         SEED],
    )
    return hashlib.sha256(key.encode()).hexdigest()[:10]


def simulate(d: str):
    """Genomes + truth-labeled reads (cached as files)."""
    fa = os.path.join(d, "db.fa")
    fq1 = os.path.join(d, "r1.fq")
    fq2 = os.path.join(d, "r2.fq")
    truth_p = os.path.join(d, "truth.tsv")
    if all(os.path.exists(p) for p in (fa, fq1, fq2, truth_p)):
        return fa, fq1, fq2, truth_p
    rng = np.random.default_rng(SEED)
    decode = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_g = N_SPECIES + N_DECOYS
    log(f"simulating {n_g} genomes x {GENOME_LEN/1e3:.0f} kbp")
    genomes = [
        rng.integers(0, 4, GENOME_LEN).astype(np.uint8) for _ in range(n_g)
    ]
    with open(fa, "wb") as f:
        for i, g in enumerate(genomes):
            f.write(f">genome{i}\n".encode())
            f.write(decode[g].tobytes())
            f.write(b"\n")
    # uneven abundance over the 22 sampled species: log-spaced weights
    # covering ~4 orders of magnitude (most reads from few species,
    # a long tail of rare ones — the metagenomic regime)
    w = np.logspace(0, -3.7, N_SPECIES)
    w /= w.sum()
    counts = rng.multinomial(N_PAIRS, w)
    log(f"per-species pair counts: max {counts.max()}, min {counts.min()}")
    comp = np.array([3, 2, 1, 0], np.uint8)
    rows = []
    for sp in range(N_SPECIES):
        for j in range(counts[sp]):
            rows.append(sp)
    rng.shuffle(rows)
    with open(fq1, "wb") as f1, open(fq2, "wb") as f2, open(truth_p, "w") as ft:
        qual = b"I" * READ_LEN
        for i, sp in enumerate(rows):
            g = genomes[sp]
            p = int(rng.integers(0, GENOME_LEN - INSERT))
            r1 = g[p : p + READ_LEN].copy()
            seg = g[p + INSERT - READ_LEN : p + INSERT]
            r2 = comp[seg[::-1]].copy()
            for arr in (r1, r2):
                nerr = rng.binomial(READ_LEN, ERR)
                for _ in range(int(nerr)):
                    q = int(rng.integers(0, READ_LEN))
                    arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
            name = f"rd{i:06d}"
            f1.write(b"@" + name.encode() + b"\n" + decode[r1].tobytes()
                     + b"\n+\n" + qual + b"\n")
            f2.write(b"@" + name.encode() + b"\n" + decode[r2].tobytes()
                     + b"\n+\n" + qual + b"\n")
            ft.write(f"{name}\t{sp}\n")
    return fa, fq1, fq2, truth_p


def write_taxonomy(d: str):
    n_g = N_SPECIES + N_DECOYS
    nodes = os.path.join(d, "nodes.dmp")
    if not os.path.exists(nodes):
        with open(nodes, "w") as f:
            f.write("1\t|\t1\t|\tno rank\t|\t\n")
            f.write("2\t|\t1\t|\tsuperkingdom\t|\t\n")
            for i in range(n_g):
                f.write(f"{10+i}\t|\t2\t|\tspecies\t|\t\n")
        with open(os.path.join(d, "names.dmp"), "w") as f:
            f.write("1\t|\troot\t|\t\t|\tscientific name\t|\n")
            f.write("2\t|\tBacteria\t|\t\t|\tscientific name\t|\n")
            for i in range(n_g):
                f.write(f"{10+i}\t|\tSpecies {i}\t|\t\t|\tscientific name\t|\n")
        with open(os.path.join(d, "acc2tid.map"), "w") as f:
            f.write("accession\taccession.version\ttaxid\tgi\n")
            for i in range(n_g):
                f.write(f"genome{i}\tgenome{i}.1\t{10+i}\t0\n")
    return d


def run_reference(d, fa, fq1, fq2):
    """soap4 + cc tail -> (lsam.id path, report, ra.report)."""
    lsam = os.path.join(d, "ref.lsam.id")
    rep = os.path.join(d, "ref.report")
    ra_rep = os.path.join(d, "ref.ra.report")
    if all(os.path.exists(p) for p in (lsam, rep, ra_rep)):
        return lsam, rep, ra_rep
    if not os.path.exists(fa + ".index.pac"):
        sh([os.path.join(REFBUILD, "soap4", "2bwt-lib", "2bwt-builder"), fa])
    cfq = os.path.join(d, "ref.cfq")
    ini = "/root/reference/soap4/soap4-nt2.ini"
    t = time.time()
    with open(cfq, "wb") as f:
        sh(
            [os.path.join(REFBUILD, "soap4", "soap4"), "pair",
             fa + ".index", fq1, fq2, "-C", ini, *SOAP4_FLAGS, "-T", "2"],
            stdout=f,
        )
    log(f"reference soap4: {time.time()-t:.1f} s")
    cc = os.path.join(REFBUILD, "cc")
    with open(lsam, "wb") as f, open(cfq, "rb") as fin:
        p1 = subprocess.Popen(
            [os.path.join(cc, "fastq2lsam"), "1"], stdin=fin,
            stdout=subprocess.PIPE,
        )
        p2 = subprocess.Popen(
            [os.path.join(cc, "taxLookupAcc"), os.path.join(d, "acc2tid.map"),
             os.path.join(d, "nodes.dmp"), os.path.join(d, "names.dmp"), "-"],
            stdin=p1.stdout, stdout=f,
        )
        p1.stdout.close()
        p2.communicate()
        assert p2.returncode == 0
    with open(rep, "wb") as f:
        subprocess.run(
            [os.path.join(cc, "genKrakenReport"), os.path.join(d, "nodes.dmp"),
             os.path.join(d, "names.dmp"), lsam, "40"],
            stdout=f, check=True,
        )
    ra = os.path.join(d, "ref.ra.lsam.id")
    with open(ra, "wb") as f:
        subprocess.run(
            [os.path.join(cc, "reassign"), "-p", "2", "-t", "40", lsam],
            stdout=f, check=True,
        )
    with open(ra_rep, "wb") as f:
        subprocess.run(
            [os.path.join(cc, "genKrakenReport"), os.path.join(d, "nodes.dmp"),
             os.path.join(d, "names.dmp"), ra, "40"],
            stdout=f, check=True,
        )
    return lsam, rep, ra_rep


def run_ours(d, fa, fq1, fq2):
    """MegaPathPipeline end to end on the same inputs."""
    from megapath.utils.compile_cache import use_compile_cache

    use_compile_cache()
    from megapath.index.fm import build_fm_index
    from megapath.index.pack import pack_fasta_file
    from megapath.pipeline.megapath import MegaPathPipeline, PipelineConfig
    from megapath.taxonomy.taxdb import TaxDB
    from megapath.io.fastq import read_fastx

    ref = pack_fasta_file(fa)
    t = time.time()
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
    log(f"our index: {time.time()-t:.1f} s")
    db = TaxDB(size=4096)
    db.read_nodes(os.path.join(d, "nodes.dmp"))
    db.read_names(os.path.join(d, "names.dmp"))
    db.read_acc2tid(os.path.join(d, "acc2tid.map"))
    pipe = MegaPathPipeline(
        [(ref, fm)], db,
        config=PipelineConfig(
            read_len=READ_LEN, skip_human=True, device_seeding=True,
            max_read_len=READ_LEN,
        ),
    )
    recs1 = list(read_fastx(fq1))
    recs2 = list(read_fastx(fq2))
    t = time.time()
    res = pipe.run_records(recs1, recs2)
    dt = time.time() - t
    log(f"our pipeline: {dt:.1f} s ({2*len(recs1)/dt:.0f} reads/s)")
    from megapath.io.lsam import write_lsam

    ours_lsam = os.path.join(d, "ours.lsam.id")
    write_lsam(res.lsam_id, ours_lsam)
    with open(os.path.join(d, "ours.report"), "w") as f:
        f.write(res.report)
    with open(os.path.join(d, "ours.ra.report"), "w") as f:
        f.write(res.ra_report)
    return (
        ours_lsam,
        os.path.join(d, "ours.report"),
        os.path.join(d, "ours.ra.report"),
        2 * len(recs1) / dt,
    )


def score_lsam(lsam_path, truth, threshold=40):
    """Read-level species sensitivity/FDR (calcAccuracy.pl logic:
    a read is TP when its hit species set contains the truth; every
    reported wrong species hit is an FP unit)."""
    tp = fp = fn = 0
    import gzip

    op = gzip.open if lsam_path.endswith(".gz") else open
    with op(lsam_path, "rt") as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            name, score, hits = c[0], int(c[2]), c[5]
            truth_tid = truth.get(name)
            if truth_tid is None:
                continue
            if score < threshold or hits == "*":
                fn += 1
                continue
            tids = set()
            for seg in hits.split(";"):
                if seg:
                    tids.add(int(seg.split(",")[1]))
            if truth_tid in tids:
                tp += 1
                fp += len(tids) - 1
            else:
                fn += 1
                fp += len(tids)
    sens = tp / max(tp + fn, 1)
    fdr = fp / max(tp + fp, 1)
    return {"tp": tp, "fp": fp, "fn": fn,
            "sensitivity": round(sens, 5), "fdr": round(fdr, 5)}


def report_species(path):
    """Species taxids present in a Kraken report (S rows, reads>0)."""
    out = {}
    for line in open(path):
        c = line.rstrip("\n").split("\t")
        if len(c) >= 6 and c[3] == "S" and int(c[1]) > 0:
            out[int(c[4])] = int(c[1])
    return out


def main() -> None:
    ensure_refbuild()
    d = os.path.join(CACHE, f"e2e_{cfg_hash()}")
    os.makedirs(d, exist_ok=True)
    fa, fq1, fq2, truth_p = simulate(d)
    write_taxonomy(d)
    truth = {}
    for line in open(truth_p):
        name, sp = line.split()
        truth[name] = 10 + int(sp)
    present = sorted({t for t in truth.values()})

    ref_lsam, ref_rep, ref_ra = run_reference(d, fa, fq1, fq2)
    our_lsam, our_rep, our_ra, rps = run_ours(d, fa, fq1, fq2)

    ref_score = score_lsam(ref_lsam, truth)
    our_score = score_lsam(our_lsam, truth)
    ref_sp = report_species(ref_ra)
    our_sp = report_species(our_ra)
    true_set = set(present)
    res = {
        "metric": "e2e_eval",
        "pairs": N_PAIRS,
        "species": N_SPECIES,
        "ref": ref_score,
        "ours": our_score,
        "ref_species_detected": len(set(ref_sp) & true_set),
        "our_species_detected": len(set(our_sp) & true_set),
        "ref_false_species": len(set(ref_sp) - true_set),
        "our_false_species": len(set(our_sp) - true_set),
        "our_reads_per_sec": round(rps, 1),
        "ra_report_identical": open(ref_ra, "rb").read()
        == open(our_ra, "rb").read(),
        "report_identical": open(ref_rep, "rb").read()
        == open(our_rep, "rb").read(),
    }
    print(json.dumps(res))
    if "--write-md" in sys.argv:
        with open(os.path.join(HERE, "EVAL.md"), "w") as f:
            f.write(
                "# End-to-end evaluation vs the reference pipeline\n\n"
                "Simulated community per calcAccuracy.pl's design: "
                f"{N_SPECIES} species (uneven abundance over ~4 orders "
                f"of magnitude), {N_DECOYS} decoy genomes in the DB, "
                f"{N_PAIRS} pairs x {READ_LEN} bp, {ERR*100:.1f}% error "
                f"rate (tools/e2e_eval.py, seed {SEED}).\n\n"
                "| metric | reference | megapath |\n|---|---|---|\n"
                f"| read sensitivity (species) | {ref_score['sensitivity']} "
                f"| {our_score['sensitivity']} |\n"
                f"| read FDR | {ref_score['fdr']} | {our_score['fdr']} |\n"
                f"| species detected (of {N_SPECIES}) | "
                f"{res['ref_species_detected']} | "
                f"{res['our_species_detected']} |\n"
                f"| false species | {res['ref_false_species']} | "
                f"{res['our_false_species']} |\n"
                f"| nt.report byte-identical | - | {res['report_identical']} |\n"
                f"| nt.ra.report byte-identical | - | "
                f"{res['ra_report_identical']} |\n"
            )
        log("wrote EVAL.md")


if __name__ == "__main__":
    main()
