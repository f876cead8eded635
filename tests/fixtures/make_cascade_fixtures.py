"""Generate the 2-shard cascade golden fixtures by running the REAL
reference pipeline (soap4 shard cascade with cfq-comment chaining +
the cc toolchain). Outputs land in /tmp/shardpar; copy shard*.fa,
r*.fq, ref.lsam.id -> tests/fixtures/cascade/cascade.lsam.id and
ref.report -> cascade.report. Requires the oracles built per
.claude/skills/verify/SKILL.md."""
import os, subprocess, sys
import numpy as np

sys.path.insert(0, "/root/repo")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")

from megapath.index.pack import COMPLEMENT, decode_seq
FIX = "/root/repo/tests/fixtures"
WD = "/tmp/shardpar"
os.makedirs(WD, exist_ok=True)
os.chdir(WD)

rng = np.random.default_rng(555)
READ_LEN, INSERT = 80, 300
# shard 0: bacteria; shard 1: viruses (accessions from mini acc2tid)
shards = [
    {"NC_000913.3 E coli": rng.integers(0, 4, 6000).astype(np.uint8),
     "NC_003197.2 Salmonella": rng.integers(0, 4, 5000).astype(np.uint8)},
    {"NC_045512.2 SARS2": rng.integers(0, 4, 4000).astype(np.uint8),
     "AF304460.1 HCoV": rng.integers(0, 4, 3000).astype(np.uint8)},
]
open("acc_check","w").write("")
for si, seqs in enumerate(shards):
    with open(f"shard{si}.fa", "w") as f:
        for name, codes in seqs.items():
            f.write(f">{name}\n{decode_seq(codes)}\n")

allseqs = {}
for d in shards: allseqs.update(d)
names = list(allseqs)
r1p, r2p = "r1.fq", "r2.fq"
qual = "I" * READ_LEN
with open(r1p, "w") as f1, open(r2p, "w") as f2:
    idx = 0
    def emit(a, b):
        global idx
        f1.write(f"@rd{idx:05d}/1\n{decode_seq(a)}\n+\n{qual}\n")
        f2.write(f"@rd{idx:05d}/2\n{decode_seq(b)}\n+\n{qual}\n")
        idx += 1
    for _ in range(120):
        src = names[int(rng.integers(0, len(names)))]
        codes = allseqs[src]
        p = int(rng.integers(0, len(codes) - INSERT))
        a = codes[p : p + READ_LEN].copy()
        seg = codes[p + INSERT - READ_LEN : p + INSERT]
        b = COMPLEMENT[seg[::-1]].copy()
        for arr in (a, b):
            for _ in range(int(rng.poisson(0.8))):
                q = int(rng.integers(0, READ_LEN))
                arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
        emit(a, b)
    for _ in range(15):  # junk
        emit(rng.integers(0, 4, READ_LEN).astype(np.uint8),
             rng.integers(0, 4, READ_LEN).astype(np.uint8))

def run(cmd, **kw):
    r = subprocess.run(cmd, shell=True, capture_output=True, text=True, **kw)
    if r.returncode != 0:
        print("FAIL:", cmd, "\n", r.stderr[-3000:]); sys.exit(1)
    return r

# ---- reference cascade ----
B = "/tmp/refbuild"
for si in range(2):
    run(f"{B}/soap4/2bwt-lib/2bwt-builder shard{si}.fa")
INI = "/root/reference/soap4/soap4-nt2.ini"
RL = 121  # READ_LEN<=120 bumped to 121 (runMegaPath.sh:80-82)
run(f"{B}/soap4/soap4 pair shard0.fa.index {r1p} {r2p} -L {RL} -u 750 -F -C {INI} -top 95 -nc > pass0.cfq 2> pass0.err")
run(f"{B}/cc/deinterleave inter < pass0.cfq")
run(f"{B}/soap4/soap4 pair shard1.fa.index inter.pe_1.fq inter.pe_2.fq -L {RL} -u 750 -F -C {INI} -top 95 > pass1.cfq 2> pass1.err")
run(f"{B}/cc/fastq2lsam 1 < pass1.cfq > ref.lsam")
run(f"{B}/cc/taxLookupAcc {FIX}/acc2tid.map {FIX}/nodes.dmp {FIX}/names.dmp ref.lsam > ref.lsam.id 2>/dev/null")
run(f"{B}/cc/genKrakenReport {FIX}/nodes.dmp {FIX}/names.dmp ref.lsam.id 40 > ref.report")

# ---- our pipeline ----
from megapath.index.fm import build_fm_index
from megapath.index.pack import pack_fasta
from megapath.io.fastq import FastqRecord, read_fastx, trim_readno
from megapath.pipeline import MegaPathPipeline, PipelineConfig
from megapath.taxonomy import TaxDB

db = TaxDB()
db.read_nodes(f"{FIX}/nodes.dmp"); db.read_names(f"{FIX}/names.dmp"); db.read_acc2tid(f"{FIX}/acc2tid.map")

def pack(seqs):
    ref = pack_fasta([FastqRecord(k, decode_seq(v), "", "") for k, v in seqs.items()])
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
    return ref, fm

nt = [pack(s) for s in shards]
cfg = PipelineConfig(read_len=READ_LEN, skip_preprocess=True, skip_human=True)
pipe = MegaPathPipeline(nt, db, config=cfg)
recs1 = list(read_fastx(r1p)); recs2 = list(read_fastx(r2p))
for r in recs1 + recs2: r.name = trim_readno(r.name)
print("species maps:", [list(x) for x in pipe._species_of])
res = pipe.run_records(recs1, recs2)
print("stages:", res.n_input_pairs, res.n_after_preprocess, res.n_after_human, "spike:", res.spike_removed)
print("first:", res.lsam_id[0].to_line()[:80] if res.lsam_id else None)
open("our.report", "w").write(res.report)
with open("our.lsam.id", "w") as f:
    for rec in res.lsam_id:
        f.write(rec.to_line() + "\n")

import subprocess as sp
same_rep = sp.run(["cmp", "-s", "ref.report", "our.report"]).returncode == 0
print("report identical:", same_rep)
if not same_rep:
    print(sp.run(["diff", "ref.report", "our.report"], capture_output=True, text=True).stdout[:3000])
# per-read species-hit comparison
def load_id(p):
    out = {}
    for line in open(p):
        c = line.rstrip("\n").split("\t")
        key = (c[0], c[1])
        hits = frozenset(h.split(",")[1] for h in c[5].split(";")) if c[5] != "*" else frozenset()
        out[key] = (int(float(c[2])), hits)
    return out
a, b = load_id("ref.lsam.id"), load_id("our.lsam.id")
ks = set(a) | set(b)
mism = [k for k in ks if a.get(k) != b.get(k)]
print(f"read-end records: {len(ks)}, mismatches: {len(mism)}")
for k in sorted(mism)[:10]:
    print(" ", k, "ref=", a.get(k), "ours=", b.get(k))
